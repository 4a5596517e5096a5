"""The segment exchange (exchange="segment": shadow_tpu_torch/engine/
round.py::_flush_segment and equeue.push_many_segment) held against the
JAX package in the same mode: the landing slot for slot on random queues
with tombstones (one world, and two worlds against the JAX package's vmap),
tests/test_exchange.py's bursty fan-in and pool_capacity=6 flushes with
their counts and CapacityError texts, whole runs on phold (plain engine)
and on tests/test_pump.py's tgen world (pump engine, pump_k 3), an R = 2
phold ensemble against JAX's and against its single runs, and a run whose
pool overflows recovering to the run started at the grown pool. Port
segment runs equal port dense runs in (time, tie) pop order: slot
placement is the one thing the two landings lay out differently. Exact
equality throughout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_overlay import _world as _overlay_world
from test_pipeline import _phold_world
from test_pump import _world as _tgen_world
from test_torch_ensemble import port_world
from test_torch_slice import _assert_leaves_equal as assert_leaves_equal
from test_torch_slice import _jax_leaves as jax_leaves
from test_torch_slice import _normalized

from shadow_tpu import equeue as j_equeue
from shadow_tpu.engine.ensemble import init_ensemble_state as j_init_ensemble_state
from shadow_tpu.engine.ensemble import run_ensemble_until as j_run_ensemble_until
from shadow_tpu.engine.round import CapacityError as JCapacityError
from shadow_tpu.engine.round import check_capacity as j_check_capacity
from shadow_tpu.engine.round import flush_outbox as j_flush_outbox
from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.engine.state import init_state as j_init_state
from shadow_tpu.models.phold import PholdModel as JPholdModel
from shadow_tpu.netstack import bw_bits_per_sec_to_refill
from shadow_tpu.simtime import NS_PER_MS, TIME_MAX
from shadow_tpu_torch import equeue
from shadow_tpu_torch.engine.ensemble import (
    init_ensemble_state,
    replica_seeds,
    replica_slice,
    run_ensemble_until,
)
from shadow_tpu_torch.engine.round import (
    CapacityError,
    bootstrap,
    check_capacity,
    flush_outbox,
    run_until,
)
from shadow_tpu_torch.engine.state import init_state, state_from_numpy, state_to_numpy
from shadow_tpu_torch.runtime.checkpoint import CheckpointManager, peek_checkpoint_meta
from shadow_tpu_torch.runtime.recovery import RecoveryPolicy, run_until_recovering


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


I64_MAX = np.iinfo(np.int64).max
QUEUE_FIELDS = ("time", "tie", "kind", "data", "aux", "count", "overflow", "head_time")


def _random_landing(seed: int, h: int = 6, cap: int = 12, m: int = 40):
    """Numpy queue arrays and pushes for one world: rows with tombstones
    between live slots, row 0 two slots short of full; every row gets at
    least two arrivals, a few entries are invalid and a few valid ones sit
    at TIME_MAX (rejected, counted on row 0)."""
    rs = np.random.default_rng(seed)
    occupied = rs.random((h, cap)) < 0.4
    occupied[0] = True
    occupied[0, rs.choice(cap, 2, replace=False)] = False
    time = np.where(occupied, rs.integers(1_000_000, 9_000_000, (h, cap)), TIME_MAX)
    queue = dict(
        time=time.astype(np.int64),
        tie=np.where(occupied, rs.integers(1, 1 << 40, (h, cap)), I64_MAX).astype(np.int64),
        kind=rs.integers(0, 5, (h, cap)).astype(np.int32),
        data=rs.integers(-9, 9, (h, cap, equeue.PAYLOAD_LANES)).astype(np.int32),
        aux=rs.integers(0, 1500, (h, cap)).astype(np.int32),
        count=occupied.sum(axis=1).astype(np.int32),
        overflow=rs.integers(0, 3, h).astype(np.int32),
        head_time=time.min(axis=1).astype(np.int64),
    )
    dst = np.concatenate([np.repeat(np.arange(h), 2), rs.integers(0, h, m - 2 * h)])
    rs.shuffle(dst)
    valid = rs.random(m) < 0.9
    push_time = rs.integers(2_000_000, 12_000_000, m)
    push_time[rs.choice(m, 3, replace=False)] = TIME_MAX
    pushes = dict(
        dst=dst.astype(np.int32),
        valid=valid,
        time=push_time.astype(np.int64),
        tie=rs.permutation(m).astype(np.int64) + 7,
        kind=np.full(m, 2, np.int32),
        data=rs.integers(-9, 9, (m, equeue.PAYLOAD_LANES)).astype(np.int32),
        aux=rs.integers(0, 1500, m).astype(np.int32),
    )
    return queue, pushes


@pytest.mark.parametrize("worlds", [1, 2])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_push_many_segment_equals_jax_slot_for_slot(seed, worlds):
    """Every queue array equal to the reference's landing, slot layout
    included: an overflowing row, tombstones, TIME_MAX pushes. Two worlds
    are the port's ensemble rows against the JAX package's vmap."""
    cases = [_random_landing(seed * 10 + w) for w in range(worlds)]
    h = cases[0][0]["count"].shape[0]

    def stack(part, k):
        return np.stack([c[part][k] for c in cases])

    jq = j_equeue.EventQueue(**{k: jnp.asarray(stack(0, k)) for k in QUEUE_FIELDS})
    jp = {k: jnp.asarray(stack(1, k)) for k in cases[0][1]}
    want = jax.vmap(j_equeue.push_many_segment)(jq, **jp)
    assert int(np.asarray(want.overflow)[:, 0].sum()) > 0

    def rows(x):
        return torch.from_numpy(np.concatenate(list(x)))

    tq = equeue.EventQueue(**{k: rows(stack(0, k)) for k in QUEUE_FIELDS})
    tp = {k: rows(stack(1, k)) for k in cases[0][1]}
    tp["dst"] = tp["dst"].to(torch.int64) + torch.arange(worlds).repeat_interleave(
        len(cases[0][1]["dst"])) * h
    got = equeue.push_many_segment(tq, **tp, rows_per_world=h if worlds > 1 else 0)
    for k in QUEUE_FIELDS:
        np.testing.assert_array_equal(
            getattr(got, k).numpy(), np.concatenate(list(np.asarray(getattr(want, k)))),
            err_msg=k)


def _bursty(cfg):
    """tests/test_exchange.py::_bursty_state: every host of an 8-host phold
    world (empty queues) stages 2 packets, all to host 0: 16 deliveries
    into one row. Returns the JAX state and the port's copy of it."""
    st = j_init_state(cfg, JPholdModel(num_hosts=8).init())
    h, o = st.outbox.valid.shape
    valid = np.zeros((h, o), bool)
    valid[:, :2] = True
    time = np.full((h, o), TIME_MAX, np.int64)
    tie = np.zeros((h, o), np.int64)
    for i in range(h):
        for j in range(2):
            time[i, j] = 10 * NS_PER_MS + i * 2 + j
            tie[i, j] = i * 2 + j + 1
    ob = st.outbox.replace(
        valid=jnp.asarray(valid), dst=jnp.zeros((h, o), jnp.int32),
        time=jnp.asarray(time), tie=jnp.asarray(tie),
        aux=jnp.where(jnp.asarray(valid), jnp.int32(100), jnp.int32(0)),
        fill=jnp.full((h,), 2, jnp.int32),
    )
    st = st.replace(outbox=ob)
    return st, state_from_numpy(jax_leaves(st))


def _flushed(**kw):
    """Both packages' flush of the burst with the world's config changed
    by `kw` (test_exchange.py's 8-host phold world: queue 64, outbox 4),
    checked leaf-equal: (JAX state, port state)."""
    model = JPholdModel(num_hosts=8)
    jcfg, jt = _overlay_world(model, seed=3, queue_capacity=64, outbox_capacity=4)
    jcfg = dataclasses.replace(jcfg, **kw)
    cfg = port_world(jcfg, model, jt)[0]
    jst, st = _bursty(jcfg)
    jst, st = j_flush_outbox(jst, None, jcfg), flush_outbox(st, cfg)
    assert_leaves_equal(jax_leaves(jst), state_to_numpy(st))
    return jst, st


def _capacity_errors(jst, st, exch_hwm: int = 0):
    """The CapacityError of both packages' check_capacity on a flushed
    state, with the tracker's exchange high-water set to exch_hwm."""
    jst = jst.replace(tracker=jst.tracker.replace(
        exch_hwm=jst.tracker.exch_hwm.at[0].set(exch_hwm)))
    st.tracker.exch_hwm[0] = exch_hwm
    with pytest.raises(JCapacityError) as jax_err:
        j_check_capacity(jst)
    with pytest.raises(CapacityError) as port_err:
        check_capacity(st)
    return jax_err.value, port_err.value


def test_port_segment_bursty_fanin_lands_in_full():
    """The burst overflows a deliver_lanes=4 dense grid (12 dropped, the
    error naming pool_capacity) but lands in full under the segment pool,
    equal to a roomy dense landing in pop order; each flush leaf-equal to
    the JAX package's."""
    jnarrow, narrow = _flushed(deliver_lanes=4, exchange="dense")
    assert int(narrow.queue.count[0]) == 4
    assert int(narrow.queue.overflow.sum()) + int(narrow.outbox.overflow.sum()) == 12
    jerr, err = _capacity_errors(jnarrow, narrow)
    assert "pool_capacity" in str(err) and str(err) == str(jerr)

    _, seg = _flushed(deliver_lanes=4, exchange="segment")
    check_capacity(seg)
    assert int(seg.queue.count[0]) == 16 and int(seg.queue.overflow.sum()) == 0
    _, roomy = _flushed(exchange="dense")
    assert_leaves_equal(_normalized(state_to_numpy(roomy)), _normalized(state_to_numpy(seg)))


def test_port_segment_pool_capacity_truncates_loudly():
    """pool_capacity=6 below the burst's 16: six land, ten count into the
    outbox overflow lane, and the CapacityError carries the pool
    occupancy high-water and the knob, as the JAX package's does."""
    jst, st = _flushed(exchange="segment", pool_capacity=6)
    assert int(st.queue.count[0]) == 6 and int(st.outbox.overflow.sum()) == 10
    jerr, err = _capacity_errors(jst, st, exch_hwm=16)
    msg = str(err)
    assert msg == str(jerr)
    assert "exchange pool occupancy hwm=16 events/round" in msg
    assert "pool_capacity" in msg and "0 = whole outbox" in msg
    assert (err.exchange_hwm, err.outbox_overflow) == (16, 10)
    assert (jerr.exchange_hwm, jerr.outbox_overflow) == (16, 10)


BW = bw_bits_per_sec_to_refill(20_000_000)
# name: (world, end, rounds per chunk, per-host byte rate)
RUNS = {
    "phold-plain": (lambda: _phold_world()[:3], 60 * NS_PER_MS, 8, None),
    "tgen-pump": (lambda: _tgen_pump_world(), 80 * NS_PER_MS, 8, BW),
}
_RUNS = {}


def _tgen_pump_world():
    jcfg, jm, jt, _ = _tgen_world(8, 0.02, 20_000_000, seed=3)
    return dataclasses.replace(jcfg, tracker=True, engine="pump", pump_k=3), jm, jt


def _port_single(cfg, model, tables, end, rpc, bw, **kw):
    c = dataclasses.replace(cfg, **kw)
    st = bootstrap(init_state(c, model.init("cpu"), bw, bw, device="cpu"), model, c)
    return run_until(st, end, model, tables, c, rounds_per_chunk=rpc)


def _segment_run(name):
    """The JAX package's segment run, the port's segment and dense runs."""
    if name not in _RUNS:
        build, end, rpc, bw = RUNS[name]
        jcfg, jm, jt = build()
        jcfg = dataclasses.replace(jcfg, exchange="segment")
        jst = j_init_state(jcfg, jm.init(), tx_bytes_per_interval=bw, rx_bytes_per_interval=bw)
        from shadow_tpu.engine.round import bootstrap as j_bootstrap

        jout = j_run_until(j_bootstrap(jst, jm, jcfg), end, jm, jt, jcfg, rounds_per_chunk=rpc)
        cfg, model, tables = port_world(jcfg, jm, jt)
        _RUNS[name] = dict(
            jax=jax_leaves(jout),
            segment=state_to_numpy(_port_single(cfg, model, tables, end, rpc, bw)),
            dense=state_to_numpy(_port_single(cfg, model, tables, end, rpc, bw,
                                              exchange="all_to_all")),
        )
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_port_segment_run_matches_jax(name):
    run = _segment_run(name)
    assert run["jax"][".events_handled"].sum() > 0
    assert run["jax"][".packets_sent"].sum() > 0
    assert_leaves_equal(run["jax"], run["segment"])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_port_segment_run_pop_order_equals_dense(name):
    run = _segment_run(name)
    assert_leaves_equal(_normalized(run["dense"]), _normalized(run["segment"]))


ENS_R, ENS_STRIDE, ENS_END, ENS_RPC = 2, 5, 40 * NS_PER_MS, 4


def _segment_ensemble():
    if "ensemble" not in _RUNS:
        jcfg, jm, jt, _ = _phold_world(seed=11)
        jcfg = dataclasses.replace(jcfg, exchange="segment", tracker=True)
        cfg, model, tables = port_world(jcfg, jm, jt)
        jens = j_run_ensemble_until(j_init_ensemble_state(jcfg, jm, ENS_R, ENS_STRIDE), ENS_END,
                                    jm, jt, jcfg, rounds_per_chunk=ENS_RPC)
        ens = run_ensemble_until(
            init_ensemble_state(cfg, model, ENS_R, ENS_STRIDE, device="cpu"), ENS_END, model,
            tables, cfg, rounds_per_chunk=ENS_RPC)
        singles = [
            state_to_numpy(_port_single(cfg, model, tables, ENS_END, ENS_RPC, None, seed=s))
            for s in replica_seeds(cfg, ENS_R, ENS_STRIDE)]
        _RUNS["ensemble"] = dict(jax=jax_leaves(jens), port=ens, singles=singles)
    return _RUNS["ensemble"]


def test_port_segment_ensemble_matches_jax():
    run = _segment_ensemble()
    assert run["jax"][".events_handled"].sum() > 0
    assert_leaves_equal(run["jax"], state_to_numpy(run["port"]))


@pytest.mark.parametrize("replica", range(ENS_R))
def test_port_segment_ensemble_replica_matches_single_run(replica):
    run = _segment_ensemble()
    assert_leaves_equal(run["singles"][replica],
                        state_to_numpy(replica_slice(run["port"], replica)))


def test_port_segment_pool_overflow_recovers_to_grown_pool_run(tmp_path):
    """A phold run whose pool_capacity (2) is below a round's traffic
    overflows the outbox lane; recovery regrows the outbox and the pool
    together and ends equal to the run started at the grown sizes, and
    the checkpoints it writes record the grown pool, which resume
    rebuilds at."""
    jcfg, jm, jt, _ = _phold_world()
    cfg, model, tables = port_world(jcfg, jm, jt)
    cfg = dataclasses.replace(cfg, exchange="segment", pool_capacity=2)
    end, rpc = 60 * NS_PER_MS, 8
    st0 = bootstrap(init_state(cfg, model.init("cpu"), device="cpu"), model, cfg)
    with pytest.raises(CapacityError, match="pool_capacity"):
        run_until(st0, end, model, tables, cfg, rounds_per_chunk=rpc)
    ckpt = CheckpointManager(str(tmp_path), 20 * NS_PER_MS, "segment-pool")
    final, records = run_until_recovering(
        st0, end, model, tables, cfg, rounds_per_chunk=rpc, checkpoints=ckpt,
        policy=RecoveryPolicy(max_recoveries=6, snapshot_interval_chunks=2))
    assert records and all(r["outbox_overflow"] > 0 for r in records)
    grown = 2 ** len(records)
    meta = peek_checkpoint_meta(CheckpointManager.latest_path(str(tmp_path)))
    assert meta["pool_capacity"] == cfg.pool_capacity * grown
    want = _port_single(cfg, model, tables, end, rpc, None,
                        outbox_capacity=cfg.outbox_capacity * grown,
                        pool_capacity=cfg.pool_capacity * grown)
    assert_leaves_equal(state_to_numpy(want), state_to_numpy(final))
