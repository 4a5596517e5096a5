"""The chaos plane (shadow_tpu_torch/runtime/chaos.py) and the engine
fallback ladder held against the JAX package's: the FaultPlan schedule
and report for the same seed and faults, `--chaos-fault` parsing and the
`chaos:` config errors message for message, next_engine_cfg and the
ladder's records, injected capacity and compile faults on
tests/test_chaos.py's phold world (tests/test_pipeline.py::_phold_world)
ending leaf-equal to the JAX package's runs, the checkpoint faults, and
the `run` entry point with every ported fault kind, and interrupted and
resumed past a damaged checkpoint: the `chaos`, `degraded` and `recovery`
sections of sim-stats.json equal the reference's (`--replicas 2` is in
test_torch_watchdog.py). The one
deliberate difference: a failure inside the compile seam that the chaos
plane did not inject (a kernel that fails to build or launch) propagates
as itself and never falls a rung. Exact equality throughout."""

import dataclasses
import json
import pathlib

import pytest
import torch

from test_pipeline import _phold_world
from test_torch_ensemble import port_world
from test_torch_slice import _assert_leaves_equal as assert_leaves_equal
from test_torch_slice import _jax_leaves as jax_leaves
from test_torch_slice import _stats

from shadow_tpu.config.options import ChaosOptions as JChaosOptions
from shadow_tpu.engine.round import EngineCompileError as JEngineCompileError
from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.runtime import chaos as jchaos
from shadow_tpu.runtime.checkpoint import CheckpointError as JCheckpointError
from shadow_tpu.runtime.checkpoint import CheckpointManager as JCheckpointManager
from shadow_tpu.runtime.checkpoint import load_checkpoint as j_load_checkpoint
from shadow_tpu.runtime.recovery import RecoveryPolicy as JRecoveryPolicy
from shadow_tpu.runtime.recovery import run_until_recovering as j_run_until_recovering
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.config.options import ChaosOptions
from shadow_tpu_torch.engine.round import EngineCompileError, run_until
from shadow_tpu_torch.engine.state import EngineConfig, state_from_numpy, state_to_host
from shadow_tpu_torch.runtime import chaos
from shadow_tpu_torch.runtime.checkpoint import (
    CheckpointError,
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
    verify_checkpoint,
)
from shadow_tpu_torch.runtime.recovery import RecoveryPolicy, run_until_recovering

END = 40 * NS_PER_MS
RPC = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _phold(queue_capacity=64):
    """tests/test_chaos.py's phold world in both packages: (JAX cfg, model,
    tables, state, port cfg, model, tables, state)."""
    jcfg, jm, jt, jst = _phold_world(queue_capacity=queue_capacity)
    cfg, model, tables = port_world(jcfg, jm, jt)
    return jcfg, jm, jt, jst, cfg, model, tables, state_from_numpy(jax_leaves(jst))


# ---- the FaultPlan schedule and report ------------------------------------

FAULTS = [
    {"kind": "capacity", "at": "auto"},
    {"kind": "stall", "at": 2, "stall_s": 0.1},
    {"kind": "compile", "target": "pump", "count": -1},
    {"kind": "ckpt-corrupt", "at": "auto", "count": 2},
    {"kind": "capacity", "at": "auto"},
]
# (kind, at, tags) fire calls, in order, some matching and some not
CALLS = [("capacity", 0, ()), ("capacity", 1, ()), ("capacity", 2, ()), ("capacity", 3, ()),
         ("compile", None, ("plain",)), ("compile", None, ("pump",)),
         ("compile", None, ("pump",)), ("stall", 1, ()), ("stall", 2, ()), ("stall", 2, ()),
         ("ckpt-corrupt", 0, ()), ("ckpt-corrupt", 1, ()), ("ckpt-corrupt", 2, ()),
         ("ckpt-corrupt", 3, ())]


@pytest.mark.parametrize("seed", [0, 1, 9, 12345])
def test_fault_plan_schedule_and_report_match_the_reference(seed):
    """Two plans from the same (seed, faults), one per package, draw the
    same `at: auto` sites, fire the same specs on the same calls, report
    the same, and replay the same after reset()."""
    want, got = jchaos.FaultPlan(seed=seed, faults=FAULTS), chaos.FaultPlan(seed=seed, faults=FAULTS)
    assert [dataclasses.asdict(s) for s in got.faults] == [
        dataclasses.asdict(s) for s in want.faults]
    for plan_pass in range(2):
        fired = [(got.should_fire(k, at=a, tags=t) is None,
                  want.should_fire(k, at=a, tags=t) is None) for k, a, t in CALLS]
        assert all(g == w for g, w in fired)
        assert got.report() == want.report()
        assert got.report()["fired"], "no fault fired: the schedule is not exercised"
        got.reset()
        want.reset()


def test_persistent_fault_report_matches_the_reference():
    """A count=-1 fault firing past MAX_FIRED_RECORDS reports the first
    records and the true total, as the reference's does."""
    assert chaos.MAX_FIRED_RECORDS == jchaos.MAX_FIRED_RECORDS
    plans = [m.FaultPlan(faults=[{"kind": "capacity", "count": -1}]) for m in (chaos, jchaos)]
    for plan in plans:
        for i in range(chaos.MAX_FIRED_RECORDS + 7):
            assert plan.should_fire("capacity", at=i) is not None
    assert plans[0].report() == plans[1].report()
    assert plans[0].report()["fired_total"] == chaos.MAX_FIRED_RECORDS + 7


def test_fire_without_plan_is_inert():
    chaos.uninstall()
    assert chaos.active() is None and chaos.fire("capacity", at=0) is None
    with chaos.installed(chaos.FaultPlan(faults=[{"kind": "capacity"}])) as p:
        assert chaos.fire("capacity") is p.faults[0]
        with chaos.scoped_tags("job-a"):
            assert chaos.fire("capacity") is None  # budget spent
    assert chaos.active() is None


@pytest.mark.parametrize("arg", [
    "capacity@2", "stall@1:stall_s=0.5", "capacity:target=ph-s3:count=-1", "ckpt-corrupt@auto",
    "compile:target=megakernel", "ckpt-truncate:at=3", "device-loss@1:target=0",
])
def test_parse_fault_arg_matches_the_reference(arg):
    assert chaos.parse_fault_arg(arg) == jchaos.parse_fault_arg(arg)


@pytest.mark.parametrize("arg", [
    "frobnicate@1", "capacity:count", "capacity:count=0", "compile@1",
    "compile@auto:target=pump", "capacity@-1", "stall:stall_s=-2", "capacity:speed=3",
])
def test_parse_fault_arg_errors_match_the_reference(arg):
    with pytest.raises(ValueError) as want:
        jchaos.parse_fault_arg(arg)
    with pytest.raises(ValueError) as got:
        chaos.parse_fault_arg(arg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fault", [
    {"kind": "capacity", "at": "soon"}, {"kind": "capacity", "at": -1},
    {"kind": "capacity", "count": 0}, {"kind": "stall", "stall_s": "fast"},
    {"kind": "stall", "stall_s": -1}, {"kind": "nope"}, {"kind": "stall", "when": 3},
    "capacity",
])
def test_chaos_config_errors_match_the_reference(fault):
    """The `chaos:` section is validated at load time with the
    reference's one-line errors."""
    with pytest.raises(ValueError) as want:
        JChaosOptions.from_dict({"faults": [fault]})
    with pytest.raises(ValueError) as got:
        ChaosOptions.from_dict({"faults": [fault]})
    assert str(got.value) == str(want.value)


def test_chaos_config_accepts_every_kind_like_the_reference():
    """The plan parses every kind of the catalog; YAML strings coerce."""
    from shadow_tpu_torch.config.options import FAULT_KINDS

    d = {"seed": 4, "faults": [{"kind": k} for k in FAULT_KINDS if k != "compile"]
         + [{"kind": "stall", "at": "2", "stall_s": "0.5"}]}
    got, want = ChaosOptions.from_dict(dict(d)), JChaosOptions.from_dict(dict(d))
    assert (got.seed, got.faults) == (want.seed, want.faults)


# ---- the engine fallback ladder -------------------------------------------


def _ecfg(cls, engine, pump_k=3):
    return cls(num_hosts=2, queue_capacity=4, outbox_capacity=4, runahead_ns=1, seed=0,
               engine=engine, pump_k=pump_k)


@pytest.mark.parametrize("engine,pump_k", [
    ("megakernel", 3), ("megakernel", 0), ("pump", 3), ("plain", 3), ("auto", 3), ("auto", 0)])
def test_next_engine_cfg_matches_the_reference_on_the_cpu(engine, pump_k):
    """On the CPU "auto" resolves as the reference's does there (pump
    when pump_k > 0, else plain) before stepping down."""
    from shadow_tpu.engine import EngineConfig as JEngineConfig

    want = jchaos.next_engine_cfg(_ecfg(JEngineConfig, engine, pump_k))
    got = chaos.next_engine_cfg(_ecfg(EngineConfig, engine, pump_k), "cpu")
    assert (got is None) == (want is None)
    if want is not None:
        assert repr(got) == repr(want)


def test_next_engine_cfg_on_the_card():
    """On the card "auto" is the megakernel, whose next rung is the pump
    (pump_k 8 when unset): the rung chip_smoke's guards phase takes."""
    nxt = chaos.next_engine_cfg(_ecfg(EngineConfig, "auto", 0), "cuda")
    assert (nxt.engine, nxt.pump_k) == ("pump", 8)
    assert chaos.next_engine_cfg(nxt, "cuda").engine == "plain"


def test_ladder_falls_to_plain_then_fails_like_the_reference():
    from shadow_tpu.engine import EngineConfig as JEngineConfig

    runs = {}
    for name, mod, err_cls, cfg_cls, kw in (
            ("ref", jchaos, JEngineCompileError, JEngineConfig, {}),
            ("port", chaos, EngineCompileError, EngineConfig, {"device": "cpu"})):
        attempts = []

        def flaky(cfg, attempts=attempts, err_cls=err_cls):
            attempts.append(cfg.engine)
            if cfg.engine != "plain":
                raise err_cls(cfg.engine, RuntimeError("boom"))
            return "done"

        result, fallbacks = mod.run_with_engine_ladder(_ecfg(cfg_cls, "megakernel"), flaky, **kw)

        def hopeless(cfg, err_cls=err_cls):
            raise err_cls(cfg.engine, RuntimeError("bad lowering"))

        with pytest.raises(err_cls) as terminal:
            mod.run_with_engine_ladder(_ecfg(cfg_cls, "pump"), hopeless, **kw)
        runs[name] = (result, attempts, fallbacks, str(terminal.value))
    assert runs["port"] == runs["ref"]
    assert runs["port"][1] == ["megakernel", "pump", "plain"]


def test_compile_fault_falls_pump_to_plain_leaf_exact():
    """An injected compile fault on the pump engine walks the ladder to
    plain in both packages with the same records; the port's run ends
    leaf-equal to the JAX package's. A compile fault on the plain engine
    has no rung left: the same named failure."""
    jcfg, jm, jt, jst, cfg, model, tables, st0 = _phold()
    faults = [{"kind": "compile", "target": "pump"}]
    jplan, plan = jchaos.FaultPlan(faults=faults), chaos.FaultPlan(faults=faults)
    with jchaos.installed(jplan):
        jfinal, jfall = jchaos.run_with_engine_ladder(
            dataclasses.replace(jcfg, engine="pump", pump_k=3),
            lambda c: j_run_until(jst, END, jm, jt, c, rounds_per_chunk=RPC))
    with chaos.installed(plan):
        final, fall = chaos.run_with_engine_ladder(
            dataclasses.replace(cfg, engine="pump", pump_k=3),
            lambda c: run_until(st0, END, model, tables, c, rounds_per_chunk=RPC), device="cpu")
    assert fall == jfall == [{"from": "pump", "to": "plain", "reason":
                              "injected fault: pump engine compile failed (chaos plane)"}]
    assert plan.report() == jplan.report()
    assert_leaves_equal(jax_leaves(jfinal), state_to_host(final))

    faults = [{"kind": "compile", "target": "plain"}]
    with jchaos.installed(jchaos.FaultPlan(faults=faults)):
        with pytest.raises(JEngineCompileError) as want:
            jchaos.run_with_engine_ladder(
                jcfg, lambda c: j_run_until(jst, END, jm, jt, c, rounds_per_chunk=RPC))
    with chaos.installed(chaos.FaultPlan(faults=faults)):
        with pytest.raises(EngineCompileError) as got:
            chaos.run_with_engine_ladder(
                cfg, lambda c: run_until(st0, END, model, tables, c, rounds_per_chunk=RPC),
                device="cpu")
    assert str(got.value) == str(want.value)


def test_non_injected_failure_in_the_seam_propagates_as_itself():
    """The port's deliberate difference: an exception inside the compile
    seam that the chaos plane did not inject is not wrapped into an
    EngineCompileError, so the ladder never runs the twin in the place
    of a kernel that failed to build (the reference wraps it)."""
    cfg = _ecfg(EngineConfig, "megakernel")
    attempts = []

    def broken(c):
        attempts.append(c.engine)
        with chaos.compile_seam(c.engine):
            raise RuntimeError("nvcc: pump_megakernel.cu failed to build")

    with pytest.raises(RuntimeError, match="failed to build") as got:
        chaos.run_with_engine_ladder(cfg, broken, device="cuda")
    assert type(got.value) is RuntimeError and attempts == ["megakernel"]
    with pytest.raises(JEngineCompileError):
        with jchaos.compile_seam("megakernel"):
            raise RuntimeError("the reference wraps it")


def test_kernel_failure_stops_the_scheduler_run(monkeypatch):
    """A megakernel run whose kernel stage fails (its first launch, where
    the kernel is built) stops TpuScheduler.run with that error, recovery
    on: no engine fallback is recorded and no other engine runs."""
    from test_cpu_ref_tgen import _world

    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.runtime.scheduler import TpuScheduler

    jcfg, jm, jt, _, bw = _world(8, 0.0, False, seed=13)
    cfg, model, tables = port_world(jcfg, jm, jt)
    cfg = dataclasses.replace(cfg, engine="megakernel", pump_k=4)
    calls = []

    def failing_stage(*args, **kw):
        calls.append(1)
        raise RuntimeError("pump_megakernel: launch failed")

    monkeypatch.setattr(mk, "megakernel_stage", failing_stage)
    sched = TpuScheduler(model, tables, cfg, rounds_per_chunk=4, device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        sched.run(50 * NS_PER_MS, recovery=RecoveryPolicy())
    assert calls == [1] and sched.engine_fallbacks == []


# ---- injected capacity ----------------------------------------------------


def test_injected_capacity_recovers_like_the_reference():
    """An injected CapacityError takes the real rollback-and-regrow path
    (the record tagged `injected`) in both packages: equal records, and
    the port's run ends leaf-equal to the JAX package's."""
    jcfg, jm, jt, jst, cfg, model, tables, st0 = _phold()
    faults = [{"kind": "capacity", "at": 1}]
    jplan, plan = jchaos.FaultPlan(faults=faults), chaos.FaultPlan(faults=faults)
    with jchaos.installed(jplan):
        jf, jrec = j_run_until_recovering(
            jst, END, jm, jt, jcfg, rounds_per_chunk=RPC,
            policy=JRecoveryPolicy(max_recoveries=2, snapshot_interval_chunks=2))
    with chaos.installed(plan):
        pf, prec = run_until_recovering(
            st0, END, model, tables, cfg, rounds_per_chunk=RPC,
            policy=RecoveryPolicy(max_recoveries=2, snapshot_interval_chunks=2))
    assert [r["kind"] for r in prec] == ["capacity"] and prec[0]["injected"] is True
    assert prec == jrec
    assert plan.report() == jplan.report()
    assert pf.queue.time.shape[1] == 128
    assert_leaves_equal(jax_leaves(jf), state_to_host(pf))


# ---- checkpoint faults ----------------------------------------------------


@pytest.mark.parametrize("truncate", [False, True], ids=["corrupt", "truncate"])
def test_damaged_checkpoint_raises_named_like_the_reference(tmp_path, truncate):
    """A damaged file fails verification and loads with the reference's
    CheckpointError, naming the file; the newest-first walk of
    latest_path falls back to the valid older file."""
    jcfg, jm, jt, jst, cfg, model, tables, st0 = _phold()
    host = state_to_host(st0)
    older = str(tmp_path / "ckpt-00000000000000000001.npz")
    newer = str(tmp_path / "ckpt-00000000000000000002.npz")
    save_checkpoint(older, host, {"fingerprint": "fp"})
    save_checkpoint(newer, host, {"fingerprint": "fp"})
    chaos.damage_file(newer, truncate=truncate)
    assert verify_checkpoint(newer) is not None and verify_checkpoint(older) is None
    with pytest.raises(JCheckpointError) as want:
        j_load_checkpoint(newer, jst, "fp")
    with pytest.raises(CheckpointError) as got:
        load_checkpoint(newer, st0, "fp")
    assert str(got.value) == str(want.value)
    assert CheckpointManager.latest_path(str(tmp_path)) == older
    assert JCheckpointManager.latest_path(str(tmp_path)) == older
    assert CheckpointManager.latest_path(str(tmp_path), verify=False) == newer


@pytest.mark.parametrize("kind", ["ckpt-corrupt", "ckpt-truncate"])
def test_ckpt_faults_damage_the_nth_write_like_the_reference(tmp_path, kind):
    """The fault hits the manager's write number `at`, after the atomic
    commit: the file fails verification, the fired record is the
    reference's, and latest_path lands on the write before it."""
    *_, st0 = _phold()
    host = state_to_host(st0)
    faults = [{"kind": kind, "at": 1}]
    plan, jplan = chaos.FaultPlan(faults=faults), jchaos.FaultPlan(faults=faults)
    with chaos.installed(plan):
        mgr = CheckpointManager(str(tmp_path), 0, "fp")
        p0 = mgr.write(host)
        p1 = mgr.write({**host, ".now": host[".now"] + 1})
    for i in range(2):
        jplan.should_fire("ckpt-corrupt", at=i)
        jplan.should_fire("ckpt-truncate", at=i)
    assert verify_checkpoint(p0) is None and verify_checkpoint(p1) is not None
    assert plan.report() == jplan.report() == {
        "seed": 0, "planned": 1, "fired": [{"kind": kind, "at": 1}]}
    assert CheckpointManager.latest_path(str(tmp_path)) == p0


# ---- the run entry point --------------------------------------------------

CONFIG = """
general:
  stop_time: 200 ms
  seed: 1
  data_directory: {data_dir}
  heartbeat_interval: null
  parallelism: 1
network:
  graph:
    type: 1_gbit_switch
experimental:
  rounds_per_chunk: 4
  engine: pump
  pump_k: 4
{chaos}hosts:
  peer:
    network_node_id: 0
    quantity: 12
    processes:
      - path: phold
        args:
          min_delay: "2 ms"
          max_delay: "12 ms"
"""
# every ported kind in one run: the compile fault drops the pump to plain
# before chunk 0, capacity regrows the queue, the stall blows the
# watchdog in the regrown replay, and the first checkpoint is damaged
FAULT_FLAGS = ["--chaos-seed", "5", "--chaos-fault", "compile:target=pump",
               "--chaos-fault", "capacity@1", "--chaos-fault", "stall@2:stall_s=2",
               "--chaos-fault", "ckpt-corrupt@0", "--chunk-watchdog", "1.0"]
INTERRUPT_ENV = "SHADOW_TPU_TEST_INTERRUPT_AT_NS"
GUARD_SECTIONS = ("chaos", "degraded", "recovery")


def _config(tmp_path, name, chaos_yaml="") -> pathlib.Path:
    path = tmp_path / f"{name}.yaml"
    path.write_text(CONFIG.format(data_dir=tmp_path / name, chaos=chaos_yaml))
    return path


def _run(main, cfg, *flags):
    extra = ("--device", "cpu") if "torch" in main.__module__ else ()
    return main(["run", *extra, *flags, str(cfg)])


def cli_every_fault_kind(tmp_path, stats, rep=()):
    """`run` with compile, capacity, stall (under the watchdog) and
    ckpt-corrupt faults (FAULT_FLAGS, plus `rep`) through both CLIs: the
    port's sim-stats (read by `stats`) equal the reference's, their
    chaos, degraded and recovery sections included, and but for those
    sections the port's fault-free run's."""
    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main as t_main

    for main, name in ((j_main, "ref"), (t_main, "port")):
        ckpt = ["--checkpoint-dir", str(tmp_path / f"ckpt-{name}"),
                "--checkpoint-interval", "40 ms"]
        assert _run(main, _config(tmp_path, name), *rep, *ckpt, *FAULT_FLAGS) == 0
    assert _run(t_main, _config(tmp_path, "clean"), *rep) == 0
    want, got = (stats(tmp_path / n / "sim-stats.json") for n in ("ref", "port"))
    clean = stats(tmp_path / "clean" / "sim-stats.json")
    assert got == want
    assert got["chaos"]["fired"] == [{"kind": "compile", "at": None, "target": "pump"},
                                      {"kind": "capacity", "at": 1},
                                      {"kind": "stall", "at": 2},
                                      {"kind": "ckpt-corrupt", "at": 0}]
    assert [r["kind"] for r in got["recovery"]["events"]] == ["capacity", "watchdog"]
    assert got["degraded"]["watchdog_redispatches"] == 1
    assert got["degraded"]["engine_fallbacks"][0]["to"] == "plain"
    # the port's own record of the engine that ran: the ladder's last rung
    execution = json.loads((tmp_path / "port" / "sim-stats.json").read_text())["execution"]
    assert execution["engine"] == "plain"
    assert {k: v for k, v in got.items() if k not in GUARD_SECTIONS} == clean
    damaged = [p for p in (tmp_path / "ckpt-port").glob("ckpt-*.npz")
               if verify_checkpoint(str(p)) is not None]
    assert not damaged or len(damaged) == 1


def test_cli_every_fault_kind_matches_shadow_tpu_run(tmp_path):
    cli_every_fault_kind(tmp_path, _stats)


@pytest.mark.parametrize("kind", ["ckpt-corrupt", "ckpt-truncate"])
def test_cli_resume_falls_back_past_a_damaged_checkpoint(tmp_path, monkeypatch, kind):
    """The run is interrupted and its final checkpoint damaged by the
    fault; `--resume` falls back to a valid one before it and ends at the
    uninterrupted run's sim-stats, in each package, which write and
    damage the same files."""
    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main as t_main

    assert _run(t_main, _config(tmp_path, "clean")) == 0
    clean = _stats(tmp_path / "clean" / "sim-stats.json")
    got = {}
    for main, name in ((j_main, "ref"), (t_main, "port")):
        cfg, ckpt = _config(tmp_path, name), str(tmp_path / f"ckpt-{name}")
        monkeypatch.setenv(INTERRUPT_ENV, str(100 * NS_PER_MS))
        flags = ["--checkpoint-dir", ckpt, "--checkpoint-interval", "40 ms"]
        assert _run(main, cfg, *flags, "--chaos-fault", f"{kind}@2") == 130
        files = sorted(pathlib.Path(ckpt).glob("ckpt-*.npz"))
        got[name] = ([p.name for p in files],
                     [verify_checkpoint(str(p)) is None for p in files])
        monkeypatch.delenv(INTERRUPT_ENV)
        assert _run(main, cfg, *flags, "--resume") == 0
        assert _stats(tmp_path / name / "sim-stats.json") == clean
    assert got["port"] == got["ref"]
    valid = got["port"][1]
    assert not valid[-1] and any(valid[:-1]), "the last file is damaged, an older one valid"


def test_later_fault_kinds_are_refused(tmp_path):
    """Every kind of the reference's catalog has its seam in the port now
    (the multi-device planes carry `device-loss`): the manager takes a
    plan naming it, and `run` with device-loss@1 on a single world, whose
    chunk loop has no device-loss seam (the reference's neither), ends as
    the JAX package's run does, nothing fired."""
    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main as t_main
    from shadow_tpu_torch.config import load_config_file
    from shadow_tpu_torch.runtime.manager import Manager

    assert not hasattr(chaos, "LATER_KINDS")
    Manager(load_config_file(str(_config(
        tmp_path, "yaml", "chaos:\n  faults:\n    - kind: device-loss\n"))), device="cpu")
    for main, name in ((j_main, "ref"), (t_main, "port")):
        assert _run(main, _config(tmp_path, name), "--chaos-fault", "device-loss@1") == 0
    want, got = (_stats(tmp_path / n / "sim-stats.json") for n in ("ref", "port"))
    assert got == want
    assert got["chaos"]["fired"] == []
