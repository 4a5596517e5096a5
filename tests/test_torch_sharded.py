"""The port's sharded engine (shadow_tpu_torch/engine/sharded.py): one
world's hosts block-sharded over 8 logical CPU devices
(SHADOW_TPU_TORCH_LOGICAL_DEVICES=8) against the JAX package's
ShardedRunner on conftest.py's 8 virtual devices, on tests/test_sharded.py's
worlds and seeds: every leaf equal, the scalar leaves included (the JAX
run's replicated outputs are read from its first device, and the port's
merged state takes them from its first shard). Cases: phold at 16 hosts
(fixed and dynamic runahead, the tracker on), bulk-tcp at 1,024 hosts on
each exchange (all_to_all, all_gather, segment), the all_to_all bucket
overflow and its per-shard error text, TpuScheduler's `parallelism`, the
split and runahead refusals, and the probe reduced over shards. The
pump kernel on one shard's rows against its twin needs a card:
tests/test_torch_shard_kernel.py."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from test_sharded import _setup, _setup_bulk
from test_torch_ensemble import port_world
from test_torch_slice import _assert_leaves_equal as assert_leaves_equal
from test_torch_slice import _jax_leaves as jax_leaves

from shadow_tpu.engine import ShardedRunner as JShardedRunner
from shadow_tpu.engine.round import CapacityError as JCapacityError
from shadow_tpu.engine.sharded import AXIS
from shadow_tpu.runtime.scheduler import TpuScheduler as JTpuScheduler
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.device import LOGICAL_DEVICES_ENV, visible_devices
from shadow_tpu_torch.engine.round import (
    CapacityError,
    ShardContext,
    run_until,
    state_probe,
)
from shadow_tpu_torch.engine.sharded import (
    ShardedRunner,
    auto_a2a_capacity,
    merge_grid,
    split_grid,
)
from shadow_tpu_torch.engine.state import EngineConfig, state_from_numpy, state_to_numpy
from shadow_tpu_torch.runtime.scheduler import TpuScheduler


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _eight_logical_devices(monkeypatch):
    monkeypatch.setenv(LOGICAL_DEVICES_ENV, "8")


def _jax_mesh():
    assert jax.device_count() == 8
    return Mesh(np.array(jax.devices()), (AXIS,))


def _both(jcfg, jmodel, jtables, jst0, end, rpc):
    """(JAX sharded leaves, port sharded leaves) of one world over 8
    devices."""
    want = jax_leaves(JShardedRunner(_jax_mesh(), jmodel, jtables, jcfg,
                                     rounds_per_chunk=rpc).run_until(jst0, end))
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    runner = ShardedRunner(visible_devices("cpu"), model, tables, cfg, rounds_per_chunk=rpc)
    got = state_to_numpy(runner.run_until(state_from_numpy(jax_leaves(jst0)), end))
    return want, got


@pytest.mark.parametrize("dynamic", [False, True], ids=["fixed", "dynamic-runahead"])
def test_port_sharded_phold_equals_jax_sharded(dynamic):
    """tests/test_sharded.py's 16-host phold world, tracker on: the port's
    8-shard run equals the JAX 8-shard run leaf for leaf (iters_done
    counted per shard on each shard's first row, min_used_lat from the
    first shard), and its host leaves equal the port's one-device run."""
    jcfg, jmodel, jtables, jst0 = _setup(num_hosts=16)
    jcfg = dataclasses.replace(jcfg, tracker=True, use_dynamic_runahead=dynamic)
    end = 50 * NS_PER_MS
    want, got = _both(jcfg, jmodel, jtables, jst0, end, 16)
    assert_leaves_equal(want, got)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    single = state_to_numpy(run_until(state_from_numpy(jax_leaves(jst0)), end, model, tables,
                                      cfg, rounds_per_chunk=16))
    for name in (".seq", ".rng_counter", ".packets_sent", ".packets_dropped",
                 ".events_handled", ".model.recv_count", ".model.send_count"):
        np.testing.assert_array_equal(got[name], single[name], err_msg=name)
    assert got[".iters_done"].reshape(8, -1)[:, 1:].sum() == 0  # each shard's row 0
    assert got[".queue.overflow"].sum() == 0 and got[".outbox.overflow"].sum() == 0


# 1,024 hosts, the reference's size: the port's eager CPU run takes a few
# seconds a mode, the JAX compile most of each case's time
@pytest.mark.parametrize("exchange", ["all_to_all", "all_gather", "segment"])
def test_port_sharded_bulk_tcp_1k_equals_jax(exchange):
    jcfg, jmodel, jtables, jst0 = _setup_bulk(num_hosts=1024, exchange=exchange)
    want, got = _both(jcfg, jmodel, jtables, jst0, 40 * NS_PER_MS, 8)
    assert_leaves_equal(want, got)
    assert got[".model.tcp.delivered"].sum() > 0


def test_port_sharded_a2a_bucket_overflow_names_shards():
    """all_to_all buckets of 4 slots a peer on a 64-host bulk-tcp world
    (each client's server 32 hosts on, 4 shards away): the entries past
    a full bucket count into the sending shard's outbox overflow, and the
    CapacityError, its per-shard breakdown and its top destination hosts
    read as the JAX package's."""
    jcfg, jmodel, jtables, jst0 = _setup_bulk(num_hosts=64, exchange="all_to_all")
    jcfg = dataclasses.replace(jcfg, a2a_capacity=4)
    with pytest.raises(JCapacityError) as want:
        JShardedRunner(_jax_mesh(), jmodel, jtables, jcfg, rounds_per_chunk=8).run_until(
            jst0, 40 * NS_PER_MS)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    runner = ShardedRunner(visible_devices("cpu"), model, tables, cfg, rounds_per_chunk=8)
    with pytest.raises(CapacityError) as got:
        runner.run_until(state_from_numpy(jax_leaves(jst0)), 40 * NS_PER_MS)
    assert str(got.value) == str(want.value)
    assert got.value.shard_detail == want.value.shard_detail
    assert "per-shard overflow: shard 0" in got.value.shard_detail
    assert got.value.outbox_overflow > 0 and got.value.queue_overflow == 0


def test_auto_a2a_capacity_matches_jax():
    from shadow_tpu.engine.sharded import auto_a2a_capacity as j_auto

    for hosts, outbox, devices, hwm in ((1024, 32, 8, None), (16, 8, 8, None),
                                        (64, 4, 4, 10), (64, 4, 4, 1000), (8, 1, 8, 0)):
        jcfg = _setup(num_hosts=16)[0]
        jcfg = dataclasses.replace(jcfg, num_hosts=hosts, outbox_capacity=outbox)
        cfg = EngineConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
        assert auto_a2a_capacity(cfg, devices, measured_hwm=hwm) == j_auto(
            jcfg, devices, measured_hwm=hwm)


def test_port_scheduler_parallelism_shards_like_jax():
    """TpuScheduler(parallelism=4) on the 16-host phold world: 4 shards,
    as the JAX scheduler takes 4 of its 8 devices; the run's every leaf
    equals the JAX scheduler's. With one logical device visible the port
    runs on one device, as the JAX scheduler does with one device."""
    jcfg, jmodel, jtables, _ = _setup(num_hosts=16)
    end = 30 * NS_PER_MS
    jsched = JTpuScheduler(jmodel, jtables, jcfg, parallelism=4, rounds_per_chunk=8)
    assert jsched.num_devices == 4
    want = jax_leaves(jsched.run(end))
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    sched = TpuScheduler(model, tables, cfg, parallelism=4, rounds_per_chunk=8, device="cpu")
    assert sched.num_devices == 4 and [d.id for d in sched.devices] == [0, 1, 2, 3]
    assert_leaves_equal(want, state_to_numpy(sched.run(end)))
    # 6 of 8 does not divide 16 hosts: the count shrinks to 4, as in JAX
    assert TpuScheduler(model, tables, cfg, parallelism=6, device="cpu").num_devices == 4
    assert JTpuScheduler(jmodel, jtables, jcfg, parallelism=6).num_devices == 4


def test_port_scheduler_one_device_without_logical_devices(monkeypatch):
    monkeypatch.delenv(LOGICAL_DEVICES_ENV)
    jcfg, jmodel, jtables, _ = _setup(num_hosts=16)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    sched = TpuScheduler(model, tables, cfg, parallelism=4, device="cpu")
    assert sched.num_devices == 1 and sched._runner is None


def test_port_sharded_rejects_uneven_split():
    jcfg, jmodel, jtables, _ = _setup(num_hosts=12)  # 12 % 8 != 0
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    with pytest.raises(ValueError, match="must divide evenly over 8 devices"):
        ShardedRunner(visible_devices("cpu"), model, tables, cfg)


def test_port_sharded_runahead_validation():
    jcfg, jmodel, jtables, jst0 = _setup(num_hosts=16)
    cfg, model, tables = port_world(jcfg, jmodel, jtables)
    bad = dataclasses.replace(cfg, runahead_ns=10**12)
    with pytest.raises(ValueError, match="exceeds the minimum path latency"):
        ShardedRunner(visible_devices("cpu"), model, tables, bad)
    with pytest.raises(ValueError, match="exceeds the minimum path latency"):
        run_until(state_from_numpy(jax_leaves(jst0)), 10 * NS_PER_MS, model, tables, bad)


def test_split_merge_and_probe_reduction():
    """split_grid / merge_grid round-trip a world (and an ensemble's
    rows); the probe reduced over the shards equals the merged state's."""
    jcfg, jmodel, jtables, jst0 = _setup(num_hosts=16)
    cfg, model, tables = port_world(dataclasses.replace(jcfg, tracker=True), jmodel, jtables)
    st = run_until(state_from_numpy(jax_leaves(jst0)), 20 * NS_PER_MS, model, tables, cfg,
                   rounds_per_chunk=4)
    devs = [d.physical for d in visible_devices("cpu")[:4]]
    cells = split_grid(st, [devs])
    assert [c.num_hosts for c in cells[0]] == [4, 4, 4, 4]
    assert [c.host_id.tolist() for c in cells[0]][1] == [4, 5, 6, 7]
    assert_leaves_equal(state_to_numpy(st), state_to_numpy(merge_grid(cells, devs[0])))
    shards = ShardContext(tuple(devs), 4)
    assert torch.equal(state_probe(cells[0], shards), state_probe(st))
