"""Capacity recovery on tests/test_pump.py's tgen world (8 shaped 20 Mbit
hosts, loss 0.02, seed 3, tracker on), rebuilt at queue_capacity 14,
outbox_capacity 8 and deliver_lanes 8: the start's burst overflows the
outbox (8 -> 16), then the queue (14 -> 28, the delivery grid 8 -> 16).
Held against the JAX package with the plain engine (here) and with the
pump engine at pump_k 3, the port's kernel twin
(test_torch_recovery_pump.py, which reuses this file's world):
the final state and the recovery report; the recovered run against the
port's run started at the grown capacities; the CapacityError of a run
without recovery, whose text carries capacity_topk's host detail and
the priced buffer bytes, equal to the JAX package's. Exact equality."""

import dataclasses

import pytest
import torch

from test_pump import _world as _tgen_world
from test_torch_ensemble import BW, port_world
from test_torch_slice import _assert_leaves_equal as assert_leaves_equal
from test_torch_slice import _jax_leaves as jax_leaves

from shadow_tpu.engine.round import CapacityError as JCapacityError
from shadow_tpu.engine.round import bootstrap as j_bootstrap
from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.engine.state import init_state as j_init_state
from shadow_tpu.runtime.recovery import RecoveryPolicy as JRecoveryPolicy
from shadow_tpu.runtime.recovery import run_until_recovering as j_run_until_recovering
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.engine.round import CapacityError, bootstrap, run_until
from shadow_tpu_torch.engine.state import init_state, state_from_numpy, state_to_numpy
from shadow_tpu_torch.runtime.recovery import RecoveryPolicy, run_until_recovering


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


END = 60 * NS_PER_MS
RPC = 4
QUEUE, OUTBOX, DELIVER = 14, 8, 8
ENGINES = {"plain": ("plain", 0), "pump3": ("pump", 3)}
# the engines this file's tests run; test_torch_recovery_pump.py runs pump3
TESTED = ["plain"]


def _world(engine):
    eng, k = ENGINES[engine]
    jcfg, jm, jt, _ = _tgen_world(8, 0.02, 20_000_000, seed=3)
    jcfg = dataclasses.replace(jcfg, queue_capacity=QUEUE, outbox_capacity=OUTBOX,
                               deliver_lanes=DELIVER, tracker=True, engine=eng, pump_k=k)
    jst = j_bootstrap(j_init_state(jcfg, jm.init(), BW, BW), jm, jcfg)
    cfg, model, tables = port_world(jcfg, jm, jt)
    return jcfg, jm, jt, jst, cfg, model, tables


def _policy(cls, n=4):
    return cls(max_recoveries=n, snapshot_interval_chunks=2)


_RUNS = {}


def _recovered(engine):
    if engine not in _RUNS:
        jcfg, jm, jt, jst, cfg, model, tables = _world(engine)
        jf, jrec = j_run_until_recovering(jst, END, jm, jt, jcfg, rounds_per_chunk=RPC,
                                          policy=_policy(JRecoveryPolicy))
        pf, prec = run_until_recovering(state_from_numpy(jax_leaves(jst)), END, model, tables,
                                        cfg, rounds_per_chunk=RPC, policy=_policy(RecoveryPolicy))
        _RUNS[engine] = (jax_leaves(jf), jrec, pf, prec, cfg, model, tables)
    return _RUNS[engine]


@pytest.mark.parametrize("engine", TESTED)
def test_recovered_run_matches_jax(engine):
    want, jrec, got, prec, *_ = _recovered(engine)
    assert [(r["queue_capacity"], r["outbox_capacity"]) for r in jrec] == [
        (QUEUE, 2 * OUTBOX), (2 * QUEUE, 2 * OUTBOX)]
    assert prec == jrec
    assert want[".model.streams_done"].sum() > 0
    assert_leaves_equal(want, state_to_numpy(got))


@pytest.mark.parametrize("engine", TESTED)
def test_recovered_run_matches_the_grown_start(engine):
    _, _, got, prec, cfg, model, tables = _recovered(engine)
    grown = dataclasses.replace(cfg, queue_capacity=prec[-1]["queue_capacity"],
                                outbox_capacity=prec[-1]["outbox_capacity"],
                                deliver_lanes=cfg.deliver_lanes * 2)
    st0 = bootstrap(init_state(grown, model.init("cpu"), BW, BW, device="cpu"), model, grown)
    straight = run_until(st0, END, model, tables, grown, rounds_per_chunk=RPC)
    assert_leaves_equal(state_to_numpy(straight), state_to_numpy(got))


def test_capacity_error_text_matches_jax():
    """Without recovery the run fails with the reference's text: the
    split, the high-water marks, the priced buffer bytes and the top
    destination hosts (capacity_topk, from the chunk the reference's
    pipelined chunk loop has in flight)."""
    jcfg, jm, jt, jst, cfg, model, tables = _world("plain")
    with pytest.raises(JCapacityError) as want:
        j_run_until(jst, END, jm, jt, jcfg, rounds_per_chunk=RPC)
    with pytest.raises(CapacityError) as got:
        run_until(state_from_numpy(jax_leaves(jst)), END, model, tables, cfg,
                  rounds_per_chunk=RPC)
    assert "top destination hosts by landed events: host" in str(got.value)
    assert "saturated buffer bytes" in str(got.value)
    assert str(got.value) == str(want.value)
    for attr in ("queue_overflow", "outbox_overflow", "queue_hwm", "outbox_hwm",
                 "bytes_current", "bytes_regrown", "shard_detail"):
        assert getattr(got.value, attr) == getattr(want.value, attr), attr
