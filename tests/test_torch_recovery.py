"""Capacity recovery (shadow_tpu_torch/runtime/recovery.py and the grow
functions it replays through) held against the JAX package on the worlds
of tests/test_robustness.py, rebuilt at capacities small enough to
overflow: grow_state and grow_ensemble_state leaf for leaf, recovered
phold runs (one world, and an R = 3 ensemble that regrows the whole
batch) with their recovery reports, the recovered run against the
port's run started at the grown capacity, the recovery budget running
out, and fail-fast (max_recoveries=0, `--no-recover`) with the
reference's CapacityError text. The tgen worlds are in
test_torch_recovery_tgen.py. Exact equality throughout."""

import dataclasses

import pytest
import torch

from test_pipeline import _phold_world
from test_torch_ensemble import port_world
from test_torch_slice import _assert_leaves_equal as assert_leaves_equal
from test_torch_slice import _jax_leaves as jax_leaves

from shadow_tpu.engine.ensemble import grow_ensemble_state as j_grow_ensemble_state
from shadow_tpu.engine.ensemble import init_ensemble_state as j_init_ensemble_state
from shadow_tpu.engine.ensemble import run_ensemble_until as j_run_ensemble_until
from shadow_tpu.engine.round import CapacityError as JCapacityError
from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.engine.state import grow_state as j_grow_state
from shadow_tpu.runtime.recovery import RecoveryPolicy as JRecoveryPolicy
from shadow_tpu.runtime.recovery import run_until_recovering as j_run_until_recovering
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.engine.ensemble import (
    grow_ensemble_state,
    init_ensemble_state,
    run_ensemble_until,
)
from shadow_tpu_torch.engine.round import CapacityError, bootstrap, run_until
from shadow_tpu_torch.engine.state import (
    grow_state,
    init_state,
    state_from_numpy,
    state_to_numpy,
)
from shadow_tpu_torch.runtime.recovery import RecoveryPolicy, run_until_recovering


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


END = 60 * NS_PER_MS
RPC = 4
# tests/test_robustness.py's phold world at queue_capacity 2 (outbox 8):
# the first chunk overflows the queue
PHOLD_QUEUE = 2
# the ensemble's: queue 2 and outbox 1 (tests/test_ensemble.py's), 3 replicas
ENS_QUEUE, ENS_OUTBOX, ENS_R = 2, 1, 3


def _phold(queue_capacity=PHOLD_QUEUE, **kw):
    jcfg, jm, jt, jst = _phold_world(queue_capacity=queue_capacity, **kw)
    cfg, model, tables = port_world(jcfg, jm, jt)
    return jcfg, jm, jt, jst, cfg, model, tables


def _policy(cls, n=4):
    return cls(max_recoveries=n, snapshot_interval_chunks=2)


_RUNS = {}


def _recovered_phold():
    """The JAX package's and the port's recovered phold runs, once."""
    if "phold" not in _RUNS:
        jcfg, jm, jt, jst, cfg, model, tables = _phold()
        jf, jrec = j_run_until_recovering(jst, END, jm, jt, jcfg, rounds_per_chunk=RPC,
                                          policy=_policy(JRecoveryPolicy))
        pf, prec = run_until_recovering(state_from_numpy(jax_leaves(jst)), END, model, tables,
                                        cfg, rounds_per_chunk=RPC, policy=_policy(RecoveryPolicy))
        _RUNS["phold"] = (jax_leaves(jf), jrec, pf, prec, cfg, model, tables)
    return _RUNS["phold"]


def test_grow_state_matches_jax():
    """grow_state on a mid-run state: old slots kept, new slots at the
    reference's fill values, leaf for leaf; shrinking is refused."""
    jcfg, jm, jt, jst, *_ = _phold(queue_capacity=64)
    jmid = j_run_until(jst, 10 * NS_PER_MS, jm, jt, jcfg, rounds_per_chunk=RPC)
    mid = state_from_numpy(jax_leaves(jmid))
    want = jax_leaves(j_grow_state(jmid, queue_capacity=128, outbox_capacity=16))
    got = grow_state(mid, queue_capacity=128, outbox_capacity=16)
    assert_leaves_equal(want, state_to_numpy(got))
    assert_leaves_equal(jax_leaves(j_grow_state(jmid, outbox_capacity=8)),
                        state_to_numpy(grow_state(mid, outbox_capacity=8)))
    with pytest.raises(ValueError, match="cannot shrink queue_capacity"):
        grow_state(mid, queue_capacity=32)
    with pytest.raises(ValueError, match="cannot shrink outbox_capacity"):
        grow_state(mid, outbox_capacity=4)


def test_grow_ensemble_state_matches_jax():
    """grow_ensemble_state widens every replica of an [R, ...] stack."""
    jcfg, jm, jt, _, cfg, model, tables = _phold(queue_capacity=64)
    jmid = j_run_ensemble_until(j_init_ensemble_state(jcfg, jm, ENS_R, 2), 10 * NS_PER_MS, jm,
                                jt, jcfg, rounds_per_chunk=RPC)
    mid = state_from_numpy(jax_leaves(jmid))
    want = jax_leaves(j_grow_ensemble_state(jmid, queue_capacity=96, outbox_capacity=24))
    got = grow_ensemble_state(mid, queue_capacity=96, outbox_capacity=24)
    assert got.queue.time.shape == (ENS_R, cfg.num_hosts, 96)
    assert_leaves_equal(want, state_to_numpy(got))


def test_recovered_run_matches_jax():
    """phold at queue_capacity 2 recovers (queue 2 -> 4) to the JAX
    package's final state, with the same recovery report: rung, buffer,
    old -> new capacity, rollback point, priced bytes."""
    want, jrec, got, prec, *_ = _recovered_phold()
    assert len(jrec) >= 1 and jrec[0]["queue_overflow"] > 0
    assert prec == jrec
    assert_leaves_equal(want, state_to_numpy(got))


def test_recovered_run_matches_the_grown_start():
    """The recovered run equals the port's run started at the grown
    capacity: growing is trajectory-neutral."""
    _, _, got, prec, cfg, model, tables = _recovered_phold()
    grown = dataclasses.replace(cfg, queue_capacity=prec[-1]["queue_capacity"],
                                outbox_capacity=prec[-1]["outbox_capacity"])
    st0 = bootstrap(init_state(grown, model.init("cpu"), device="cpu"), model, grown)
    straight = run_until(st0, END, model, tables, grown, rounds_per_chunk=RPC)
    assert_leaves_equal(state_to_numpy(straight), state_to_numpy(got))


@pytest.mark.parametrize("budget", [0, 1])
def test_budget_exhausted_raises_like_jax(budget):
    """Past the budget the CapacityError surfaces with the reference's
    text and the recoveries survived so far: budget 0 is fail-fast
    (`--no-recover`), budget 1 runs out on a world (queue 1) that needs
    two regrows."""
    q = PHOLD_QUEUE if budget == 0 else 1
    jcfg, jm, jt, jst, cfg, model, tables = _phold(queue_capacity=q)
    with pytest.raises(JCapacityError) as want:
        j_run_until_recovering(jst, END, jm, jt, jcfg, rounds_per_chunk=RPC,
                               policy=_policy(JRecoveryPolicy, budget))
    with pytest.raises(CapacityError) as got:
        run_until_recovering(state_from_numpy(jax_leaves(jst)), END, model, tables, cfg,
                             rounds_per_chunk=RPC, policy=_policy(RecoveryPolicy, budget))
    assert str(got.value) == str(want.value)
    assert "saturated: queue" in str(got.value)
    assert getattr(got.value, "recoveries", []) == getattr(want.value, "recoveries", [])
    assert len(getattr(got.value, "recoveries", [])) == budget


def _ensemble_factory(run, end, model, tables):
    def factory(c):
        def go(s, on_state=None):
            return run(s, end, model, tables, c, rounds_per_chunk=RPC, on_state=on_state)

        return go

    return factory


def test_ensemble_regrows_the_whole_batch_like_jax():
    """An R = 3 phold ensemble at queue 2 / outbox 1 regrows the whole
    batch (grow_ensemble_state) and ends at the JAX ensemble's recovered
    state, with the same report, the saturated replica named."""
    jcfg, jm, jt, _, cfg, model, tables = _phold(queue_capacity=ENS_QUEUE)
    jcfg = dataclasses.replace(jcfg, outbox_capacity=ENS_OUTBOX)
    cfg = dataclasses.replace(cfg, outbox_capacity=ENS_OUTBOX)
    j0 = j_init_ensemble_state(jcfg, jm, ENS_R, 1)
    jf, jrec = j_run_until_recovering(
        j0, END, cfg=jcfg, policy=_policy(JRecoveryPolicy),
        runner_factory=_ensemble_factory(j_run_ensemble_until, END, jm, jt),
        grow_fn=j_grow_ensemble_state)
    p0 = init_ensemble_state(cfg, model, ENS_R, 1, device="cpu")
    assert_leaves_equal(jax_leaves(j0), state_to_numpy(p0))
    pf, prec = run_until_recovering(
        p0, END, cfg=cfg, policy=_policy(RecoveryPolicy),
        runner_factory=_ensemble_factory(run_ensemble_until, END, model, tables),
        grow_fn=grow_ensemble_state)
    assert len(jrec) >= 2 and all("replica" in r for r in jrec)
    assert prec == jrec
    assert_leaves_equal(jax_leaves(jf), state_to_numpy(pf))
