"""The port's 2-D mesh plane (shadow_tpu_torch/engine/mesh.py,
runtime/mesh.py) on 8 logical CPU devices against the JAX package's mesh
on conftest.py's 8 virtual devices, case for case with
tests/test_mesh.py, on its worlds and seeds: run_mesh_until on 1x4,
2x2, 2x4 and 4x1 grids equals the JAX run leaf for leaf (every [R]
leaf and every per-shard diagnostic included, dead queue slots too),
and each replica's slice equals its single-device run modulo the
per-shard diagnostics (test_mesh.py's contract); test_pump.py's tgen
world with the pump engine at 4 replicas on 2x4 (two a grid row);
checkpoint and resume on the mesh; the capacity error naming
(replica, shard) with the reference's text; the whole-batch regrow;
the plan and spec validation; a state that does not fit the plan."""

import dataclasses

import numpy as np
import pytest
import torch

from test_mesh import _canon_queue
from test_pipeline import _phold_world
from test_pump import _world as _tgen_world
from test_torch_ensemble import port_world, single_run
from test_torch_slice import _assert_leaves_equal as assert_leaves_equal
from test_torch_slice import _jax_leaves as jax_leaves

from shadow_tpu.engine.mesh import MeshPlan as JMeshPlan
from shadow_tpu.engine.mesh import init_mesh_state as j_init_mesh_state
from shadow_tpu.engine.mesh import run_mesh_until as j_run_mesh_until
from shadow_tpu.engine.round import CapacityError as JCapacityError
from shadow_tpu.netstack import bw_bits_per_sec_to_refill
from shadow_tpu.runtime.mesh import grow_mesh_state as j_grow_mesh_state
from shadow_tpu.runtime.recovery import RecoveryPolicy as JRecoveryPolicy
from shadow_tpu.runtime.recovery import run_until_recovering as j_run_until_recovering
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.device import LOGICAL_DEVICES_ENV
from shadow_tpu_torch.engine.ensemble import replica_seeds
from shadow_tpu_torch.engine.mesh import (
    MeshPlan,
    init_mesh_state,
    mesh_engine_cfg,
    parse_mesh,
    run_mesh_until,
)
from shadow_tpu_torch.engine.round import CapacityError
from shadow_tpu_torch.engine.state import state_to_numpy
from shadow_tpu_torch.runtime.mesh import grow_mesh_state
from shadow_tpu_torch.runtime.recovery import RecoveryPolicy, run_until_recovering

DIAGNOSTICS = (".iters_done", ".lanes_live", ".tracker.exch_hwm")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _eight_logical_devices(monkeypatch):
    monkeypatch.setenv(LOGICAL_DEVICES_ENV, "8")


def _phold(seed=11, queue_capacity=64, outbox_capacity=8, tracker=True):
    jcfg, jmodel, jtables, _ = _phold_world(num_hosts=8, seed=seed,
                                            queue_capacity=queue_capacity)
    jcfg = dataclasses.replace(jcfg, tracker=tracker, outbox_capacity=outbox_capacity)
    return jcfg, jmodel, jtables


_JAX_RUNS: dict = {}


def _jax_mesh_run(key, jcfg, jmodel, jtables, plan, stride, end, rpc, bw=None):
    """The JAX mesh run's leaves, once per (world, plan) for the file."""
    if key not in _JAX_RUNS:
        jplan = JMeshPlan(plan.replicas, plan.shards, plan.rows)
        st = j_init_mesh_state(jcfg, jmodel, jplan, stride, tx_bytes_per_interval=bw,
                               rx_bytes_per_interval=bw)
        _JAX_RUNS[key] = jax_leaves(j_run_mesh_until(st, end, jmodel, jtables, jcfg, jplan,
                                                     rounds_per_chunk=rpc))
    return _JAX_RUNS[key]


def _slice_host(leaves: dict, r: int) -> dict:
    return {k: v[r] for k, v in leaves.items()}


def _assert_slice_exact(sl: dict, single: dict, what=""):
    """tests/test_mesh.py::_assert_mesh_slice_exact on leaf dicts: the
    per-shard diagnostics skipped, the queue grids compared as live
    content in (time, tie) pop order."""
    grid = (".queue.time", ".queue.tie", ".queue.kind", ".queue.data", ".queue.aux")
    assert sorted(sl) == sorted(single)
    for k in single:
        if k in DIAGNOSTICS or k in grid:
            continue
        np.testing.assert_array_equal(sl[k], single[k], err_msg=f"{k}{what}")

    class _Q:
        def __init__(self, leaves):
            for f in ("time", "tie", "kind", "data", "aux", "count"):
                setattr(self, f, leaves[f".queue.{f}"])

    for h in range(single[".queue.time"].shape[0]):
        assert _canon_queue(_Q(sl), h) == _canon_queue(_Q(single), h), f"host {h}{what}"


GRIDS = {"1x4": MeshPlan(2, 4, 1), "2x2": MeshPlan(4, 2, 2), "2x4": MeshPlan(2, 4, 2),
         "4x1": MeshPlan(4, 1, 4)}


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_port_mesh_phold_grids_equal_jax(grid):
    """tests/test_mesh.py's phold world (8 hosts, tracker on, seed stride
    7, 40 ms) on each grid: every leaf equals the JAX mesh run's; on 2x4
    each replica slice also equals its port single run (modulo the
    per-shard diagnostics), and the seeds diverge."""
    plan = GRIDS[grid]
    jcfg, jmodel, jtables = _phold()
    end, stride = 40 * NS_PER_MS, 7
    want = _jax_mesh_run(("phold", grid), jcfg, jmodel, jtables, plan, stride, end, 4)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    ens0 = init_mesh_state(cfg, model, plan, stride, device="cpu")
    got = state_to_numpy(run_mesh_until(ens0, end, model, tables, cfg, plan, rounds_per_chunk=4))
    assert_leaves_equal(want, got)
    if grid != "2x4":
        return
    totals = set()
    for r, seed in enumerate(replica_seeds(cfg, plan.replicas, stride)):
        single = state_to_numpy(single_run(cfg, model, tables, seed, end, 4))
        _assert_slice_exact(_slice_host(got, r), single, f" (replica {r})")
        totals.add(int(single[".events_handled"].sum()))
    assert len(totals) > 1


def test_port_mesh_tgen_pump_equals_jax():
    """tests/test_pump.py's tgen world (TCP, netstack shaping, deliver
    lanes) with the pump engine (the kernel's twin here), 4 replicas on a
    2x4 grid, two a row: every leaf equals the JAX mesh run's, each slice
    its single run modulo the per-shard diagnostics."""
    jcfg, jmodel, jtables, _ = _tgen_world(8, 0.02, 20_000_000, seed=3)
    jcfg = dataclasses.replace(jcfg, tracker=True, engine="pump", pump_k=3)
    bw = bw_bits_per_sec_to_refill(20_000_000)
    end, plan = 30 * NS_PER_MS, MeshPlan(4, 4, 2)
    assert plan.local_replicas == 2
    want = _jax_mesh_run("tgen", jcfg, jmodel, jtables, plan, 3, end, 8, bw=bw)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    ens0 = init_mesh_state(cfg, model, plan, 3, bw, bw, device="cpu")
    got = state_to_numpy(run_mesh_until(ens0, end, model, tables, cfg, plan, rounds_per_chunk=8))
    assert_leaves_equal(want, got)
    for r, seed in enumerate(replica_seeds(cfg, 4, 3)):
        single = state_to_numpy(single_run(cfg, model, tables, seed, end, 8, bw=bw))
        _assert_slice_exact(_slice_host(got, r), single, f" (replica {r})")


def test_port_mesh_checkpoint_resume_exact(tmp_path):
    """A checkpoint tapped at a mesh chunk boundary resumes to the
    straight run's final batch, every leaf, and that run equals the JAX
    mesh run's."""
    from shadow_tpu_torch.runtime.checkpoint import CheckpointManager, StateTap, load_checkpoint

    jcfg, jmodel, jtables = _phold(seed=29)
    end, plan = 40 * NS_PER_MS, MeshPlan(2, 4, 2)
    want = _jax_mesh_run(("phold29", "2x4"), jcfg, jmodel, jtables, plan, 1, end, 4)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    ens0 = init_mesh_state(cfg, model, plan, 1, device="cpu")
    straight = state_to_numpy(run_mesh_until(ens0, end, model, tables, cfg, plan,
                                             rounds_per_chunk=4))
    assert_leaves_equal(want, straight)
    ckpt = CheckpointManager(str(tmp_path), 10 * NS_PER_MS, "fp-mesh", layout="2x4")
    run_mesh_until(ens0, end, model, tables, cfg, plan, rounds_per_chunk=4,
                   on_state=StateTap(checkpoints=ckpt))
    assert ckpt.written, "the cadence must have written a checkpoint"
    restored, meta = load_checkpoint(ckpt.written[-1], ens0, "fp-mesh")
    assert meta["mesh"] == "2x4" and meta["queue_capacity"] == cfg.queue_capacity
    resumed = run_mesh_until(restored, end, model, tables, cfg, plan, rounds_per_chunk=4)
    assert_leaves_equal(straight, state_to_numpy(resumed))


def test_port_mesh_capacity_error_names_replica_and_shard():
    """A saturated cell names both coordinates, its counter split and the
    saturated cells, in the JAX package's words."""
    jcfg, jmodel, jtables = _phold(queue_capacity=2, outbox_capacity=1, tracker=False)
    plan = MeshPlan(2, 4, 2)
    jplan = JMeshPlan(2, 4, 2)
    with pytest.raises(JCapacityError) as want:
        j_run_mesh_until(j_init_mesh_state(jcfg, jmodel, jplan, 1), 40 * NS_PER_MS, jmodel,
                         jtables, jcfg, jplan, rounds_per_chunk=4)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    with pytest.raises(CapacityError, match=r"\(replica \d, shard \d\)") as got:
        run_mesh_until(init_mesh_state(cfg, model, plan, 1, device="cpu"), 40 * NS_PER_MS,
                       model, tables, cfg, plan, rounds_per_chunk=4)
    err = got.value
    assert str(err) == str(want.value)
    assert (err.replica, err.shard) == (want.value.replica, want.value.shard)
    assert err.mesh_cells == want.value.mesh_cells
    assert err.shard_detail == want.value.shard_detail
    assert err.queue_overflow or err.outbox_overflow


def test_port_mesh_recovery_regrows_whole_batch():
    """One cell's overflow rolls the whole batch back and regrows every
    replica's buffers together: the recovered final batch and the
    recovery records equal the JAX package's, and the batch equals a run
    that started at the grown capacity."""
    jcfg, jmodel, jtables = _phold(queue_capacity=2, tracker=False)
    end, plan = 60 * NS_PER_MS, MeshPlan(2, 4, 2)
    jplan = JMeshPlan(2, 4, 2)

    def jfactory(run_cfg):
        return lambda st, on_state=None: j_run_mesh_until(
            st, end, jmodel, jtables, run_cfg, jplan, rounds_per_chunk=4, on_state=on_state)

    jfinal, jrec = j_run_until_recovering(
        j_init_mesh_state(jcfg, jmodel, jplan, 1), end, cfg=jcfg,
        policy=JRecoveryPolicy(max_recoveries=4, snapshot_interval_chunks=2),
        runner_factory=jfactory, grow_fn=j_grow_mesh_state)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)

    def factory(run_cfg):
        return lambda st, on_state=None: run_mesh_until(
            st, end, model, tables, run_cfg, plan, rounds_per_chunk=4, on_state=on_state)

    final, rec = run_until_recovering(
        init_mesh_state(cfg, model, plan, 1, device="cpu"), end, cfg=cfg,
        policy=RecoveryPolicy(max_recoveries=4, snapshot_interval_chunks=2),
        runner_factory=factory, grow_fn=grow_mesh_state)
    assert rec == jrec and rec and "replica" in rec[0]
    got = state_to_numpy(final)
    assert_leaves_equal(jax_leaves(jfinal), got)
    grown = rec[-1]["queue_capacity"]
    assert grown > cfg.queue_capacity
    big = dataclasses.replace(cfg, queue_capacity=grown)
    started_big = run_mesh_until(init_mesh_state(big, model, plan, 1, device="cpu"), end, model,
                                 tables, big, plan, rounds_per_chunk=4)
    assert_leaves_equal(got, state_to_numpy(started_big))


def test_port_mesh_plan_and_spec_validation():
    assert parse_mesh("2x4") == (2, 4)
    assert parse_mesh("1X8") == (1, 8)
    assert parse_mesh("2×4") == (2, 4)
    with pytest.raises(ValueError, match="RxS"):
        parse_mesh("2x")
    with pytest.raises(ValueError, match=">= 1"):
        parse_mesh("0x4")
    with pytest.raises(ValueError, match="multiple"):
        MeshPlan(replicas=3, shards=4, rows=2)
    assert MeshPlan.for_batch(1, 2, 4).rows == 1
    assert MeshPlan.for_batch(6, 4, 2).rows == 3
    assert MeshPlan.for_batch(8, 2, 4).local_replicas == 4
    for args in ((1, 2, 4), (6, 4, 2), (8, 2, 4), (5, 4, 1), (12, 8, 2)):
        assert dataclasses.astuple(MeshPlan.for_batch(*args)) == dataclasses.astuple(
            JMeshPlan.for_batch(*args))
    jcfg, jmodel, jtables, _ = _phold_world(num_hosts=6)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    with pytest.raises(ValueError, match="divide evenly"):
        init_mesh_state(cfg, model, MeshPlan(replicas=2, shards=4, rows=2), device="cpu")
    # the exchange pin: dense modes run all_gather on the mesh, the
    # segment exchange keeps its ring
    assert mesh_engine_cfg(cfg).exchange == "all_gather"
    assert mesh_engine_cfg(dataclasses.replace(cfg, exchange="segment")).exchange == "segment"
    assert mesh_engine_cfg(cfg).ensemble
    # a grid of more logical devices than are visible is refused
    with pytest.raises(ValueError, match="mesh 4x4 needs 16 devices, 8 visible"):
        MeshPlan(4, 4, 4).build_mesh(device="cpu")
    grid = MeshPlan(2, 4, 2).build_mesh(device="cpu")
    assert grid.shape == (2, 4) and grid.ids == tuple(range(8))


def test_port_mesh_rejects_mismatched_state():
    jcfg, jmodel, jtables, _ = _phold_world(num_hosts=8)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    plan = MeshPlan(replicas=2, shards=4, rows=2)
    from shadow_tpu_torch.engine.round import bootstrap
    from shadow_tpu_torch.engine.state import init_state

    st0 = bootstrap(init_state(cfg, model.init("cpu"), device="cpu"), model, cfg)
    with pytest.raises(ValueError, match="ensemble state"):
        run_mesh_until(st0, 10 * NS_PER_MS, model, tables, cfg, plan)
    ens3 = init_mesh_state(cfg, model, MeshPlan(replicas=3, shards=4, rows=3), device="cpu")
    with pytest.raises(ValueError, match="plan expects"):
        run_mesh_until(ens3, 10 * NS_PER_MS, model, tables, cfg, plan)
