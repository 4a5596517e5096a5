"""The port's parallel hybrid (ParallelHybridScheduler): hosts sharded
over kernel worker processes, packets on the port's device engine (here
on the CPU). It equals the port's serial hybrid and the JAX package's
hybrid on tests/test_hybrid_parallel.py's world (guest stdout, exit
codes, syscall sequences, the sorted event log, the stats), and its
supervision recovers the worker-kill and worker-hang chaos faults to the
clean run's outcome with the reference's reports (tests/test_chaos.py,
tests/test_hybrid_supervision.py)."""

import time

import pytest

from test_torch_hostk import (
    W,
    _one_torch_thread,  # noqa: F401  (module fixture)
    bins,  # noqa: F401  (module fixture)
    tables_pair,
)

from shadow_tpu.engine import EngineConfig as JEngineConfig
from shadow_tpu.hostk.kernel import NetKernel as JNetKernel
from shadow_tpu.hostk.kernel import ProcessSpec as JProcessSpec
from shadow_tpu.runtime.hybrid import HybridScheduler as JHybridScheduler
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.hostk.kernel import NetKernel, ProcessSpec
from shadow_tpu_torch.runtime import chaos
from shadow_tpu_torch.runtime.chaos import FaultPlan
from shadow_tpu_torch.runtime.hybrid import (
    HybridScheduler,
    ParallelHybridScheduler,
    WorkerCrashed,
)
from shadow_tpu_torch.simtime import NS_PER_MS, NS_PER_SEC

SEED = 5


def _specs(spec_cls, bins, n_pairs, nbytes):
    specs = []
    for i in range(n_pairs):
        specs.append(spec_cls(host=f"server{i}", args=[bins["tcp_echo_server"], "8080", "1"]))
        specs.append(spec_cls(
            host=f"client{i}", args=[bins["tcp_client"], f"server{i}", "8080", str(nbytes)],
            start_ns=(100 + 10 * i) * NS_PER_MS))
    return specs


def _world(n_pairs, loss, cfg_cls):
    names = [f"server{i}" for i in range(n_pairs)] + [f"client{i}" for i in range(n_pairs)]
    nodes = [0] * n_pairs + [1] * n_pairs
    jt, tt = tables_pair(nodes, loss)
    cfg = cfg_cls(num_hosts=2 * n_pairs, queue_capacity=256, outbox_capacity=64,
                  runahead_ns=W, seed=SEED)
    return (jt if cfg_cls is JEngineConfig else tt), cfg, names, nodes


def _info(procs):
    return {p["host"]: (p["stdout"], p["exit_code"], p["syscalls"]) for p in procs}


def run_serial_hybrid(package, tmp_path, bins, n_pairs, loss, nbytes, until_s):
    jax_side = package == "ref"
    tables, cfg, names, nodes = _world(n_pairs, loss,
                                       JEngineConfig if jax_side else EngineConfig)
    kcls, scls = (JNetKernel, JProcessSpec) if jax_side else (NetKernel, ProcessSpec)
    k = kcls(tables, host_names=names, host_nodes=nodes, seed=SEED,
             data_dir=tmp_path / f"serial-{package}", window_ns=W)
    runner = (JHybridScheduler(k, tables, cfg) if jax_side
              else HybridScheduler(k, tables, cfg, device="cpu"))
    procs = [k.add_process(s) for s in _specs(scls, bins, n_pairs, nbytes)]
    try:
        runner.run(until_s * NS_PER_SEC)
    finally:
        k.shutdown()
    info = _info([{"host": p.host.name, "stdout": p.stdout(), "exit_code": p.exit_code,
                   "syscalls": [s for _, s, _ in p.syscall_log]} for p in procs])
    return k.stats(), sorted(k.event_log), info


def run_parallel(tmp_path, bins, name, n_pairs=1, loss=0.0, nbytes=6000, until_s=30,
                 num_workers=2, plan=None, **kw):
    """One port parallel run (under a fault plan when given); returns
    (stats, sorted event log, guest info, respawns, device passes)."""
    tables, cfg, names, nodes = _world(n_pairs, loss, EngineConfig)
    sched = ParallelHybridScheduler(
        tables, cfg, host_names=names, host_nodes=nodes,
        specs=_specs(ProcessSpec, bins, n_pairs, nbytes), num_workers=num_workers,
        seed=SEED, data_dir=tmp_path / name, device="cpu", **kw)
    with chaos.installed(plan):
        try:
            try:
                sched.run(until_s * NS_PER_SEC)
            finally:
                sched.shutdown()
            return (sched.stats(), sorted(sched.event_log()), _info(sched.proc_info()),
                    list(sched._respawns), sched.device_passes)
        finally:
            sched.close()


@pytest.mark.parametrize("loss", [0.0, 0.03])
def test_parallel_matches_serial_and_reference(tmp_path, bins, loss):  # noqa: F811
    n_pairs, nbytes, until_s = 3, 30_000, 90
    want = run_serial_hybrid("ref", tmp_path, bins, n_pairs, loss, nbytes, until_s)
    serial = run_serial_hybrid("port", tmp_path, bins, n_pairs, loss, nbytes, until_s)
    stats, log, info, respawns, passes = run_parallel(
        tmp_path, bins, "par", n_pairs, loss, nbytes, until_s, num_workers=3)
    assert passes > 0 and respawns == [0, 0, 0]
    for h, (out, _code, _calls) in info.items():
        if h.startswith("client"):
            assert f"echoed {nbytes}/{nbytes} bytes".encode() in out, h
    assert (stats, log, info) == serial
    assert serial == want


@pytest.mark.parametrize("kind", ["worker-kill", "worker-hang"])
def test_worker_faults_recover_identically(tmp_path, bins, kind):  # noqa: F811
    """A chaos fault on worker1 before window broadcast 1: the dead (or
    stopped, then timed out) worker is respawned once, replayed, and the
    run ends as the clean run does; the plan reports what it fired. As in
    the reference's test (tests/test_chaos.py), only the hang case runs
    with a 5 s RPC timeout, the time a stopped worker is given before it
    counts as hung: the kill case keeps the default, so that a live
    worker slow to start or to answer on a loaded machine is not taken
    for a hung one and respawned a second time."""
    clean = run_parallel(tmp_path, bins, "clean")
    assert clean[3] == [0, 0]
    plan = FaultPlan(faults=[{"kind": kind, "at": 1, "target": "worker1"}])
    t0 = time.monotonic()
    timeout = {"rpc_timeout_s": 5} if kind == "worker-hang" else {}
    hurt = run_parallel(tmp_path, bins, "hurt", plan=plan, **timeout)
    assert hurt[3] == [0, 1]  # exactly one respawn, of the faulted worker
    assert plan.report()["fired"] == [{"kind": kind, "at": 1, "target": "worker1"}]
    assert hurt[:3] == clean[:3] and hurt[4] == clean[4]
    assert time.monotonic() - t0 < 300


def test_respawn_budget_exhausted_raises(tmp_path, bins):  # noqa: F811
    plan = FaultPlan(faults=[{"kind": "worker-kill", "at": 1, "target": "worker1"}])
    with pytest.raises(WorkerCrashed, match="respawn budget"):
        run_parallel(tmp_path, bins, "budget", plan=plan, max_worker_respawns=0)


def test_close_reaps_dead_worker(tmp_path, bins):  # noqa: F811
    tables, cfg, names, nodes = _world(1, 0.0, EngineConfig)
    sched = ParallelHybridScheduler(
        tables, cfg, host_names=names, host_nodes=nodes,
        specs=_specs(ProcessSpec, bins, 1, 1000), num_workers=2, seed=SEED,
        data_dir=tmp_path / "reap", device="cpu")
    procs = [p for p, _c in sched._workers]
    procs[0].kill()
    time.sleep(0.3)
    t0 = time.monotonic()
    sched.close()
    assert time.monotonic() - t0 < 30
    assert not any(p.is_alive() for p in procs)
