"""The multi-device planes through the port's entry points on 8 logical
CPU devices, against the JAX package's on conftest.py's 8 virtual
devices (tests/test_elastic_cli.py and test_mesh.py's sweep pin, case
for case): `run --mesh 2x4` and its checkpoint resumed on 1x2 and on one
device, each sim-stats.json equal to the JAX run's (but for wall-clock
and execution-shape fields); a device-loss fault completing on a
degraded grid with the JAX run's `mesh`, `recovery` and `chaos`
sections; `run --mesh 2x2` equal to `run --replicas 2`; a scripted
world's `parallelism: 4`; `mem --mesh`; a `sweep` with `mesh: 2x4`
packing four jobs into one batch with one build, each job equal to the
JAX sweep's and to its standalone run; and `serve --mesh`: a daemon
killed the instant a 2x4 batch's checkpoint commits, whose restart on
1x2 resumes the batch from that checkpoint and journals both grids."""

import json
import pathlib
import shutil

import pytest
import torch

from test_torch_daemon import (
    BASE_CONFIG,
    journal,
    job_stats,
    manifest,
    serve_port,
    serve_subprocess,
    spec_file,
    standalone,
)
from test_torch_slice import _stats

from shadow_tpu.runtime.cli_run import run_from_config as j_run
from shadow_tpu.runtime.cli_run import run_sweep as j_sweep
from shadow_tpu_torch.device import LOGICAL_DEVICES_ENV
from shadow_tpu_torch.runtime.cli_run import CliUserError, run_from_config, run_sweep

CONFIG = """
general:
  stop_time: 160 ms
  seed: 5
  data_directory: {data_dir}
  heartbeat_interval: null
{extra}network:
  graph:
    type: 1_gbit_switch
experimental:
  rounds_per_chunk: 4
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
INTERRUPT_ENV = "SHADOW_TPU_TEST_INTERRUPT_AT_NS"
SHAPE = ("wall_seconds", "scheduler", "mesh", "recovery", "degraded", "chaos", "metrics",
         "autotune", "memory", "execution")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _eight_logical_devices(monkeypatch):
    monkeypatch.setenv(LOGICAL_DEVICES_ENV, "8")


def _write(tmp_path, name, extra="") -> pathlib.Path:
    d = tmp_path / name
    d.mkdir()
    cfg = d / "shadow.yaml"
    cfg.write_text(CONFIG.format(data_dir=d / "data", extra=extra))
    return cfg


def _raw(cfg: pathlib.Path) -> dict:
    return json.loads((cfg.parent / "data" / "sim-stats.json").read_text())


def _grid_free(cfg: pathlib.Path) -> dict:
    """tests/test_elastic_cli.py::_stats: sim-stats without wall-clock and
    execution-shape fields (the grid, the scheduler, the degradation
    record), and the port's `execution` section."""
    stats = _raw(cfg)
    for k in SHAPE:
        stats.pop(k, None)
    ens = stats.get("ensemble")
    if ens:
        for k in ("wall_seconds", "wall_seconds_per_replica",
                  "sim_sec_per_wall_sec_per_replica"):
            ens.pop(k, None)
        (ens.get("aggregate") or {}).pop("events_per_wall_second", None)
    return stats


_REF: dict = {}


def _jax_2x4(tmp_path) -> dict:
    """The JAX package's uninterrupted `run --mesh 2x4`, once a module."""
    if "2x4" not in _REF:
        cfg = _write(tmp_path, "jax-2x4")
        assert j_run(str(cfg), mesh="2x4") == 0
        _REF["2x4"] = _grid_free(cfg)
    return _REF["2x4"]


def test_port_cli_mesh_checkpoint_resumes_on_any_grid(tmp_path, monkeypatch):
    """`run --mesh 2x4` equals the JAX run; its checkpoint written at
    80 ms (an interrupt) carries the grid as metadata and resumes on 1x2
    and on one device (a pure ensemble) to the same sim-stats; a resume
    into another world is refused naming the key."""
    ref = _jax_2x4(tmp_path)
    cfg = _write(tmp_path, "port-2x4")
    assert run_from_config(str(cfg), device="cpu", mesh="2x4") == 0
    assert _grid_free(cfg) == ref
    assert len(ref["ensemble"]["per_replica"]) == 2 and ref["events_handled"] > 0
    assert _raw(cfg)["mesh"] == {"replicas": 2, "shards": 4, "rows": 2,
                                 "requested": "2x4", "effective": "2x4"}
    assert _raw(cfg)["execution"]["logical_devices"] == list(range(8))

    run_cfg, ckpt_dir = _write(tmp_path, "run"), tmp_path / "ckpts"
    monkeypatch.setenv(INTERRUPT_ENV, str(80_000_000))
    assert run_from_config(str(run_cfg), device="cpu", mesh="2x4",
                           checkpoint_dir=str(ckpt_dir), checkpoint_interval="40 ms") == 130
    monkeypatch.delenv(INTERRUPT_ENV)
    written = sorted(ckpt_dir.glob("ckpt-*.npz"))
    assert written, "the interrupt must leave a checkpoint"
    meta = json.loads(__import__("numpy").load(written[-1])["__meta__"][()])
    assert meta["mesh"] == "2x4"
    for name, kwargs in (("r1x2", dict(mesh="1x2", replicas=2)), ("rsingle", dict(replicas=2))):
        cdir = tmp_path / f"ckpts-{name}"
        shutil.copytree(ckpt_dir, cdir)
        cfg = _write(tmp_path, name)
        assert run_from_config(str(cfg), device="cpu", checkpoint_dir=str(cdir), resume=True,
                               **kwargs) == 0, name
        assert _grid_free(cfg) == ref, name
    bad = _write(tmp_path, "bad")
    with pytest.raises(CliUserError, match=r"general\.replicas: 2 != 4") as ei:
        run_from_config(str(bad), device="cpu", checkpoint_dir=str(ckpt_dir), resume=True,
                        mesh="1x2", replicas=4)
    assert "saved on grid 2x4, resuming on grid 1x2" in str(ei.value)


def test_port_cli_device_loss_completes_on_degraded_grid(tmp_path):
    """device-loss@1 on device 3 of 2x4: the run ends on a degraded grid,
    its `mesh`, `recovery` and `chaos` sections equal to the JAX run's,
    the rest to the fault-free run's."""
    ref = _jax_2x4(tmp_path)
    raws = {}
    for name, fn, kw in (("ref", j_run, {}), ("port", run_from_config, {"device": "cpu"})):
        cfg = _write(tmp_path, f"lossy-{name}")
        assert fn(str(cfg), mesh="2x4", chaos_faults=["device-loss@1:target=3"], **kw) == 0
        raws[name] = _raw(cfg)
        assert _grid_free(cfg) == ref, name
    raw = raws["port"]
    for section in ("mesh", "recovery", "chaos"):
        assert raw[section] == raws["ref"][section], section
    assert raw["mesh"]["requested"] == "2x4" and raw["mesh"]["effective"] != "2x4"
    assert raw["mesh"]["degradations"][0]["grid_from"] == "2x4"
    rec = raw["recovery"]["events"][0]
    assert rec["kind"] == "device-loss" and rec["injected"] and rec["device"] == 3
    assert raw["chaos"]["fired"] == [{"kind": "device-loss", "at": 1, "target": "3"}]


def test_port_cli_mesh_equals_replicas_and_refusals(tmp_path):
    """`run --mesh 2x2` and `run --replicas 2` publish the same sim-stats
    (but for the mesh section and the execution shape); the reference's
    refusals of a mesh, with its messages."""
    a, b = _write(tmp_path, "mesh"), _write(tmp_path, "reps")
    assert run_from_config(str(a), device="cpu", mesh="2x2") == 0
    assert run_from_config(str(b), device="cpu", replicas=2) == 0
    assert _grid_free(a) == _grid_free(b)
    assert _raw(a)["scheduler"] == "tpu-mesh" and _raw(b)["scheduler"] == "tpu-ensemble"
    for extra, kw in (("  parallelism: 2\n", dict(mesh="2x2")),
                      ("", dict(mesh="2x3")),
                      ("", dict(mesh="2x2", replicas=3)),
                      ("", dict(mesh="4x4"))):
        msgs = []
        for name, fn, dev in (("ref", j_run, {}), ("port", run_from_config, {"device": "cpu"})):
            cfg = _write(tmp_path, f"bad-{name}-{len(list(tmp_path.iterdir()))}", extra)
            # each package raises its own CliUserError
            with pytest.raises(Exception, match="mesh") as ei:
                fn(str(cfg), **kw, **dev)
            assert type(ei.value).__name__ == "CliUserError"
            msgs.append(str(ei.value))
        assert msgs[1] == msgs[0], kw


def test_port_cli_scripted_parallelism_shards_like_jax(tmp_path):
    """A scripted world's `parallelism: 4` shards its hosts over 4 logical
    devices: sim-stats equal to the JAX package's 4-device run."""
    stats = {}
    for name, fn, kw in (("ref", j_run, {}), ("port", run_from_config, {"device": "cpu"})):
        cfg = _write(tmp_path, name, "  parallelism: 4\n  tracker: true\n")
        assert fn(str(cfg), **kw) == 0
        stats[name] = _stats(cfg.parent / "data" / "sim-stats.json")
    assert stats["port"] == stats["ref"]
    port = json.loads((tmp_path / "port" / "data" / "sim-stats.json").read_text())
    assert port["execution"]["logical_devices"] == [0, 1, 2, 3]


def test_port_cli_mem_mesh_prices_like_jax(tmp_path, capsys):
    from test_torch_memtrack import assert_same_but_widened

    from shadow_tpu.cli import main as j_main
    from shadow_tpu_torch.cli import main as t_main

    cfg = _write(tmp_path, "mem")
    assert j_main(["mem", str(cfg), "--mesh", "2x4", "--json"]) == 0
    want = json.loads(capsys.readouterr().out)
    assert t_main(["mem", str(cfg), "--mesh", "2x4", "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert_same_but_widened(want, got)
    assert got["replicas"] == 2


SWEEP_BASE = """
general:
  stop_time: 60 ms
  heartbeat_interval: null
  tracker: true
network:
  graph:
    type: 1_gbit_switch
experimental:
  rounds_per_chunk: 4
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


def test_port_cli_sweep_mesh_four_jobs_one_build(tmp_path):
    """A 4-job sweep with `mesh: 2x4` packs into one 2x4 batch, prepares
    its chunk once, and each job's sim-stats equals the JAX sweep's; seed
    3's equals its standalone `run`; the seeds diverge."""
    manifests = {}
    for name, fn, kw in (("ref", j_sweep, {}), ("port", run_sweep, {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        (d / "base.yaml").write_text(SWEEP_BASE)
        (d / "sweep.yaml").write_text(
            f"sweep:\n  base: base.yaml\n  output_dir: {d / 'out'}\n  capacity: 4\n"
            "  mesh: 2x4\n  jobs:\n    - name: ph\n      seed_range: [0, 4]\n")
        assert fn(str(d / "sweep.yaml"), **kw) == 0
        manifests[name] = json.loads((d / "out" / "sweep-manifest.json").read_text())
    m = manifests["port"]
    assert m["mesh"] == "2x4" and m["jobs_done"] == 4
    assert len(m["batches"]) == 1 and m["batches"][0]["replicas"] == 4
    assert m["compile_cache"]["compiles"] == 1
    assert m["batches"][0]["mesh_effective"] == "2x4"
    events = []
    for seed in range(4):
        job = _stats(tmp_path / "port" / "out" / "jobs" / f"ph-s{seed}" / "sim-stats.json")
        assert job == _stats(tmp_path / "ref" / "out" / "jobs" / f"ph-s{seed}"
                             / "sim-stats.json"), seed
        events.append(job["events_handled"])
    assert all(e > 0 for e in events) and len(set(events)) > 1
    alone = tmp_path / "alone-s3.yaml"
    alone.write_text(SWEEP_BASE.replace(
        "general:", f"general:\n  seed: 3\n  data_directory: {tmp_path / 'alone-s3'}"))
    assert run_from_config(str(alone), device="cpu") == 0
    assert _stats(tmp_path / "port" / "out" / "jobs" / "ph-s3" / "sim-stats.json") == _stats(
        tmp_path / "alone-s3" / "sim-stats.json")


def test_port_serve_mesh_resumes_a_batch_on_another_grid(tmp_path):
    """`serve --mesh 2x4` SIGKILLed the instant its batch's first
    checkpoint commits; the restart with `--mesh 1x2` resumes that batch
    from the checkpoint (the journal naming the grid that wrote it and
    the grid that resumes it), and both jobs end equal to their
    standalone runs."""
    from shadow_tpu_torch.runtime.cli_run import run_submit

    assert BASE_CONFIG["general"]["checkpoint_interval"] == "20 ms"
    spool = tmp_path / "spool"
    assert run_submit(str(spool), str(spec_file(tmp_path, "e.yaml", "erin", "ph", [0, 1]))) == 0
    r = serve_subprocess(spool, "--mesh", "2x4",
                         "--chaos-fault", "daemon-kill@0:target=checkpoint")
    assert r.returncode in (-9, 137), r.stderr[-800:]
    starts = [x for x in journal(spool) if x["type"] == "batch-start"]
    assert starts and starts[0]["mesh"] == "2x4"
    assert serve_port(spool, mesh="1x2") == 0
    resume = manifest(spool)["daemon"]["resume"]
    batch = next(b for b in resume["batches"] if "erin.ph-s0" in b["jobs"])
    assert batch["checkpoint"] and batch["mesh"] == "2x4" and batch["mesh_resume"] == "1x2"
    starts = [x for x in journal(spool) if x["type"] == "batch-start"]
    assert starts[-1]["mesh"] == "1x2" and starts[-1]["resume"]
    root = str(tmp_path / "alone")
    pathlib.Path(root).mkdir()
    for name, seed in (("erin.ph-s0", 0), ("erin.ph-s1", 1)):
        assert job_stats(spool, name) == standalone(root, seed), name
