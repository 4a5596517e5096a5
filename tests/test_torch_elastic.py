"""The elastic mesh in the port (runtime/mesh.py MeshRunner, the
device-loss rung of runtime/recovery.py, grid-portable checkpoints),
case for case with tests/test_elastic.py, on 8 logical CPU devices
against the JAX package on conftest.py's 8 virtual devices:
MeshPlan.degraded's rungs (the reference's on every case of that file and
on an exhaustive sweep of small grids); device_loss_from on
torch.AcceleratorError (CUDA's error texts stand for the reference's XLA
statuses); an injected device loss that degrades 2x4 and replays, every
leaf and the recovery and degradation records equal to the JAX run's;
the loss terminal outside the mesh; the capacity error's naming and the
whole-batch regrow on a grid reached by degradation; the seeded retry
backoff; the mesh as layout metadata in the fingerprint; the checkpoint
mismatch message naming keys and grids; a sweep batch finishing on a
degraded grid."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from test_pipeline import _phold_world
from test_torch_ensemble import port_world
from test_torch_mesh import _assert_slice_exact, _slice_host
from test_torch_slice import _assert_leaves_equal as assert_leaves_equal
from test_torch_slice import _jax_leaves as jax_leaves
from test_torch_slice import _stats

from shadow_tpu.engine.mesh import MeshPlan as JMeshPlan
from shadow_tpu.engine.round import CapacityError as JCapacityError
from shadow_tpu.runtime import chaos as jchaos
from shadow_tpu.runtime.mesh import MeshRunner as JMeshRunner
from shadow_tpu.runtime.recovery import RecoveryPolicy as JRecoveryPolicy
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.device import LOGICAL_DEVICES_ENV
from shadow_tpu_torch.engine.mesh import MeshPlan
from shadow_tpu_torch.engine.round import (
    CapacityError,
    DeviceLossError,
    WatchdogExpired,
    device_loss_from,
)
from shadow_tpu_torch.engine.state import state_to_numpy
from shadow_tpu_torch.runtime import chaos
from shadow_tpu_torch.runtime.mesh import MeshRunner
from shadow_tpu_torch.runtime.recovery import RecoveryPolicy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _eight_logical_devices(monkeypatch):
    monkeypatch.setenv(LOGICAL_DEVICES_ENV, "8")


def _plans(p):
    return None if p is None else (p.replicas, p.shards, p.rows)


# --- the degradation ladder ----------------------------------------------


def test_port_mesh_degradation_ladder_order():
    plan = MeshPlan(replicas=2, shards=4, rows=2)
    nxt = plan.degraded(7, 8)
    assert (nxt.rows, nxt.shards) == (2, 2)
    nxt2 = nxt.degraded(7, 8)
    assert (nxt2.rows, nxt2.shards) == (2, 1)
    nxt3 = nxt2.degraded(7, 8)
    assert (nxt3.rows, nxt3.shards) == (1, 1)
    assert nxt3.local_replicas == 2
    assert nxt3.degraded(8, 8) is None


def test_port_mesh_degradation_honors_survivors_and_divisibility():
    plan = MeshPlan(replicas=2, shards=4, rows=2)
    nxt = plan.degraded(3, 8)
    assert (nxt.rows, nxt.shards) == (1, 2)
    nxt6 = MeshPlan(replicas=2, shards=3, rows=2).degraded(5, 6)
    assert (nxt6.rows, nxt6.shards) == (2, 1)
    assert MeshPlan(replicas=4, shards=1, rows=1).degraded(8, 8) is None


def test_port_mesh_degradation_equals_jax_on_every_small_grid():
    """Every plan of up to 8 rows x 8 shards (replicas a multiple of the
    rows), every surviving count 1..8 and hosts 6, 8, 12: the port's
    rung is the JAX package's."""
    for rows in range(1, 9):
        for shards in range(1, 9):
            for replicas in (rows, 2 * rows):
                plan, jplan = MeshPlan(replicas, shards, rows), JMeshPlan(replicas, shards, rows)
                for alive in range(1, 9):
                    for hosts in (6, 8, 12):
                        assert _plans(plan.degraded(alive, hosts)) == _plans(
                            jplan.degraded(alive, hosts)), (rows, shards, replicas, alive, hosts)


# --- DeviceLossError translation -----------------------------------------


def test_device_loss_from_translates_cuda_runtime_errors():
    """CUDA runtime failures that mean the card is gone become a
    DeviceLossError (the reference's XLA INTERNAL/UNAVAILABLE/...);
    out-of-memory, argument errors, a kernel's illegal address or assert
    and a launch timeout do not, nor does a plain RuntimeError."""
    accel = torch.AcceleratorError
    err = accel("CUDA error: unspecified launch failure\nCUDA kernel errors might be "
                "asynchronously reported at some other API call")
    loss = device_loss_from(err, 5)
    assert isinstance(loss, DeviceLossError)
    assert loss.chunk == 5 and not loss.injected and loss.device_id is None
    assert "lost a device at chunk 5: CUDA error: unspecified launch failure" in str(loss)
    for text in ("CUDA error: uncorrectable ECC error encountered",
                 "CUDA error: CUDA-capable device(s) is/are busy or unavailable",
                 "CUDA error: unknown error"):
        assert device_loss_from(accel(text), 2) is not None, text
    for text in ("CUDA error: out of memory",
                 "CUDA error: invalid argument",
                 "CUDA error: an illegal memory access was encountered",
                 "CUDA error: device-side assert triggered",
                 "CUDA error: the launch timed out and was terminated"):
        assert device_loss_from(accel(text), 1) is None, text
    assert device_loss_from(WatchdogExpired(1, 0.5), 1) is None
    assert device_loss_from(RuntimeError("CUDA error: unspecified launch failure"), 1) is None
    assert device_loss_from(ValueError("shape"), 1) is None
    pre = DeviceLossError(2, device_id=3)
    assert device_loss_from(pre, 9) is pre


# --- injected device loss: degrade and replay ----------------------------


def _both_mesh_runs(plan_args, faults, end, queue_capacity=64, outbox_capacity=8,
                    max_recoveries=4):
    """The JAX and the port MeshRunner on test_elastic.py's phold world
    under one fault plan: (JAX runner, JAX leaves or error, port runner,
    port leaves or error)."""
    jcfg, jmodel, jtables, _ = _phold_world(num_hosts=8, queue_capacity=queue_capacity)
    jcfg = dataclasses.replace(jcfg, outbox_capacity=outbox_capacity)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    out = []
    for runner, ch, policy, leaves in (
        (JMeshRunner(jmodel, jtables, jcfg, plan=JMeshPlan(*plan_args), rounds_per_chunk=4),
         jchaos, JRecoveryPolicy, jax_leaves),
        (MeshRunner(model, tables, cfg, plan=MeshPlan(*plan_args), rounds_per_chunk=4,
                    device="cpu"), chaos, RecoveryPolicy, state_to_numpy),
    ):
        fault = ch.FaultPlan(seed=0, faults=faults)
        with ch.installed(fault):
            try:
                res = leaves(runner.run(end, recovery=policy(
                    max_recoveries=max_recoveries, snapshot_interval_chunks=2)))
            except Exception as e:  # noqa: BLE001 — compared below
                res = e
        out += [runner, res, fault]
    return out


def test_port_device_loss_degrades_mesh_and_replays_like_jax():
    """device-loss@2 on device 3 of a 2x4 grid: the batch finishes on 2x2,
    which avoids the lost device, with one degradation record; the final
    batch, the recovery report and the degradations equal the JAX run's,
    and the batch equals the fault-free run on the grid requested."""
    from shadow_tpu_torch.engine.mesh import init_mesh_state, run_mesh_until

    faults = [{"kind": "device-loss", "at": 2, "target": "3"}]
    jr, want, jfault, pr, got, fault = _both_mesh_runs((2, 4, 2), faults, 40 * NS_PER_MS)
    assert_leaves_equal(want, got)
    assert pr.recovery_report == jr.recovery_report
    assert pr.mesh_degradations == jr.mesh_degradations
    assert fault.report() == jfault.report()
    d = pr.mesh_degradations[0]
    assert d["grid_from"] == "2x4" and d["device"] == 3 and d["grid_to"] == "2x2"
    rec = pr.recovery_report[0]
    assert rec["kind"] == "device-loss" and rec["injected"] and rec["device"] == 3
    assert all(dev.id != 3 for dev in np.asarray(pr._get_mesh().devices).ravel())
    clean = state_to_numpy(run_mesh_until(
        init_mesh_state(pr.cfg, pr.model, MeshPlan(2, 4, 2), 1, device="cpu"), 40 * NS_PER_MS,
        pr.model, pr.tables, pr.cfg, MeshPlan(2, 4, 2), rounds_per_chunk=4))
    # another grid: equal but for the per-shard diagnostics and the slot
    # layout of the queues (tests/test_elastic.py::_assert_batch_exact)
    for r in range(2):
        _assert_slice_exact(_slice_host(got, r), _slice_host(clean, r), f" (replica {r})")


def test_port_device_loss_terminal_outside_mesh_is_structured():
    """The ensemble runner has nothing to degrade onto: its device loss is
    terminal and typed, as in the JAX package; a loss of a device the run
    does not occupy never fires."""
    from shadow_tpu_torch.runtime.ensemble import EnsembleRunner

    jcfg, jmodel, jtables, _ = _phold_world(num_hosts=8)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    runner = EnsembleRunner(model, tables, cfg, 2, rounds_per_chunk=4, device="cpu")
    policy = RecoveryPolicy(max_recoveries=4, snapshot_interval_chunks=2)
    with chaos.installed(chaos.FaultPlan(seed=0, faults=[{"kind": "device-loss", "at": 1}])):
        with pytest.raises(DeviceLossError, match="lost a device at chunk 1") as ei:
            runner.run(40 * NS_PER_MS, recovery=policy)
    assert ei.value.recoveries == []
    idle = chaos.FaultPlan(seed=0, faults=[{"kind": "device-loss", "at": 1, "target": "7"}])
    with chaos.installed(idle):
        runner.run(40 * NS_PER_MS, recovery=policy)
    assert not idle.fired, "an idle device's loss must not fire"


# --- grids reached by degradation ----------------------------------------


def test_port_capacity_naming_on_grid_reached_via_degradation():
    """After device-loss@0 on device 7 burns the only recovery, the real
    overflow's CapacityError names coordinates within the degraded grid,
    in the JAX package's words, with the degradation it survived."""
    faults = [{"kind": "device-loss", "at": 0, "target": "7"}]
    jr, want, _, pr, got, _ = _both_mesh_runs((2, 4, 2), faults, 40 * NS_PER_MS,
                                              queue_capacity=2, outbox_capacity=1,
                                              max_recoveries=1)
    assert isinstance(want, JCapacityError) and isinstance(got, CapacityError)
    assert str(got) == str(want)
    assert pr.plan.shards < 4 and (got.replica, got.shard) == (want.replica, want.shard)
    assert got.mesh_cells == want.mesh_cells
    assert all(c["shard"] < pr.plan.shards for c in got.mesh_cells)
    assert [r["kind"] for r in got.recoveries] == ["device-loss"]
    assert got.recoveries == want.recoveries


def test_port_whole_batch_regrow_on_grid_reached_via_degradation():
    """1x2 loses device 1 at chunk 0 and runs on 1x1, where the queue of
    2 overflows and regrows: the final batch and the records equal the
    JAX run's, and the batch equals a 1x2 run started at the grown
    capacity."""
    from shadow_tpu_torch.engine.mesh import init_mesh_state, run_mesh_until

    faults = [{"kind": "device-loss", "at": 0, "target": "1"}]
    end = 60 * NS_PER_MS
    jr, want, _, pr, got, _ = _both_mesh_runs((2, 2, 1), faults, end, queue_capacity=2,
                                              max_recoveries=5)
    assert_leaves_equal(want, got)
    assert pr.recovery_report == jr.recovery_report
    kinds = [r["kind"] for r in pr.recovery_report]
    assert kinds[0] == "device-loss" and "capacity" in kinds
    grown = next(r["queue_capacity"] for r in reversed(pr.recovery_report)
                 if r["kind"] == "capacity")
    big = dataclasses.replace(pr.cfg, queue_capacity=grown)
    plan = MeshPlan(2, 2, 1)
    started = run_mesh_until(init_mesh_state(big, pr.model, plan, 1, device="cpu"), end,
                             pr.model, pr.tables, big, plan, rounds_per_chunk=4)
    started = state_to_numpy(started)
    for r in range(2):
        _assert_slice_exact(_slice_host(got, r), _slice_host(started, r), f" (replica {r})")


# --- seeded retry backoff -------------------------------------------------


def test_port_retry_backoff_seeded_bounded_jitter():
    from shadow_tpu.runtime.sweep import retry_backoff_s as j_backoff
    from shadow_tpu_torch.runtime.sweep import retry_backoff_s

    assert retry_backoff_s(1.0, "t.ph-s3", 1) == retry_backoff_s(1.0, "t.ph-s3", 1)
    for attempt in (1, 2, 3):
        base = 1.0 * 2 ** (attempt - 1)
        v = retry_backoff_s(1.0, "t.ph-s3", attempt)
        assert base * 0.5 <= v < base * 1.5
        assert v == j_backoff(1.0, "t.ph-s3", attempt)
    assert len({round(retry_backoff_s(1.0, f"t.ph-s{i}", 1), 6) for i in range(8)}) == 8
    assert retry_backoff_s(0.0, "t.ph-s3", 2) == 0.0


# --- grid-portable fingerprints and the refusal text ----------------------

_CFG = """
general:
  stop_time: 1 s
  seed: {seed}
  {extra}
hosts:
  peer:
    network_node_id: 0
    quantity: 8
    processes:
      - path: phold
        args: {{min_delay: "2 ms", max_delay: "12 ms"}}
"""


def _cfg(seed=1, extra=""):
    from shadow_tpu_torch.config import load_config_str

    return load_config_str(_CFG.format(seed=seed, extra=extra))


def test_port_fingerprint_mesh_is_layout_metadata():
    from shadow_tpu.config import load_config_str as j_load
    from shadow_tpu.config.fingerprint import config_fingerprint as j_fp
    from shadow_tpu_torch.config.fingerprint import config_fingerprint

    on_2x4 = config_fingerprint(_cfg(extra="mesh: 2x4"))
    assert on_2x4 == config_fingerprint(_cfg(extra="replicas: 2\n  mesh: 1x2"))
    assert on_2x4 == config_fingerprint(_cfg(extra="replicas: 2"))
    assert on_2x4 != config_fingerprint(_cfg(extra="replicas: 3"))
    assert on_2x4 != config_fingerprint(_cfg(extra="mesh: 4x2"))
    for extra in ("mesh: 2x4", "replicas: 3", "mesh: 4x2"):
        assert config_fingerprint(_cfg(extra=extra)) == j_fp(
            j_load(_CFG.format(seed=1, extra=extra)))


def test_port_checkpoint_mismatch_names_keys_and_grids(tmp_path):
    from shadow_tpu_torch.config.fingerprint import config_fingerprint, fingerprint_dict
    from shadow_tpu_torch.engine.round import bootstrap
    from shadow_tpu_torch.engine.state import init_state, state_to_host
    from shadow_tpu_torch.runtime.checkpoint import (
        CheckpointError,
        CheckpointManager,
        load_checkpoint,
        reshard_note,
    )

    jcfg, jmodel, jtables, _ = _phold_world(num_hosts=8)
    cfg, model, _ = port_world(jcfg, jmodel, jtables)
    st = bootstrap(init_state(cfg, model.init("cpu"), device="cpu"), model, cfg)
    saved = _cfg(seed=1, extra="mesh: 2x4")
    ckpt = CheckpointManager(str(tmp_path), 0, config_fingerprint(saved), layout="2x4",
                             detail=fingerprint_dict(saved))
    path = ckpt.write(state_to_host(st), final=True)
    other = _cfg(seed=1, extra="replicas: 2\n  mesh: 1x2")
    load_checkpoint(path, st, config_fingerprint(other), detail=fingerprint_dict(other),
                    layout="1x2")
    bad = _cfg(seed=2, extra="replicas: 2\n  mesh: 1x2")
    with pytest.raises(CheckpointError) as ei:
        load_checkpoint(path, st, config_fingerprint(bad), detail=fingerprint_dict(bad),
                        layout="1x2")
    msg = str(ei.value)
    assert "general.seed: 1 != 2" in msg
    assert "grid 2x4" in msg and "grid 1x2" in msg
    assert "…" not in msg
    assert reshard_note("2x4", "1x2") == ", resharding 2x4 -> 1x2"
    assert reshard_note("2x4", None) == ", resharding 2x4 -> single-device"
    assert reshard_note("2x4", "2x4") == ""


# --- a sweep batch finishing on a degraded grid ---------------------------

SWEEP_BASE = """
general:
  stop_time: 60 ms
  heartbeat_interval: null
network:
  graph:
    type: 1_gbit_switch
experimental:
  rounds_per_chunk: 4
chaos:
  faults:
    - kind: device-loss
      at: 1
      target: "1"
hosts:
  peer:
    network_node_id: 0
    quantity: 8
    processes:
      - path: phold
        args:
          min_delay: "2 ms"
          max_delay: "12 ms"
"""


def test_port_sweep_batch_survives_device_loss(tmp_path):
    """A 2x2 mesh sweep batch that loses device 1 finishes on a degraded
    grid: every job done, the reshape in the batch's manifest record, and
    the manifest's batch record and every job's sim-stats equal the JAX
    sweep's."""
    from shadow_tpu.runtime.cli_run import run_sweep as j_run_sweep
    from shadow_tpu_torch.runtime.cli_run import run_sweep

    manifests = {}
    for name, fn, kw in (("ref", j_run_sweep, {}), ("port", run_sweep, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        (d / "base.yaml").write_text(SWEEP_BASE)
        (d / "sweep.yaml").write_text(
            f"sweep:\n  base: base.yaml\n  output_dir: {d / 'out'}\n  capacity: 2\n"
            "  mesh: 2x2\n  jobs:\n    - name: ph\n      seed_range: [0, 2]\n")
        assert fn(str(d / "sweep.yaml"), **kw) == 0, "the batch must finish, not quarantine"
        manifests[name] = json.loads((d / "out" / "sweep-manifest.json").read_text())
    m, jm = manifests["port"], manifests["ref"]
    assert m["jobs_done"] == 2 and m["jobs_failed"] == 0 and m["jobs_quarantined"] == 0
    b, jb = m["batches"][0], jm["batches"][0]
    assert b["status"] == "done" and b["recoveries"] >= 1
    assert b["mesh_effective"] != "2x2"
    assert b["mesh_degradations"][0]["grid_from"] == "2x2"
    for key in ("status", "recoveries", "mesh_effective", "mesh_degradations", "replicas"):
        assert b[key] == jb[key], key
    for job, jjob in zip(m["jobs"], jm["jobs"]):
        assert job["status"] == jjob["status"] == "done"
        got = _stats(pathlib.Path(job["data_directory"]) / "sim-stats.json")
        want = _stats(pathlib.Path(jjob["data_directory"]) / "sim-stats.json")
        assert got == want
        assert got["events_handled"] > 0
