"""The chunk watchdog (engine/round.py run_chunk, _fetch_probe, WatchdogExpired, the
`watchdog` rung of runtime/recovery.py) held against the JAX package's on
tests/test_chaos.py's phold world, for one world and for an R = 2
ensemble: an injected stall under the watchdog re-dispatches from the
retained snapshot and ends leaf-equal to the JAX package's run with the
same recovery records and fault report; so does a chunk whose launch
itself is slow, which the port's watchdog bounds because its launch
waits on the chunk's device work; a persistent stall past the
budget fails with the reference's WatchdogExpired and the recoveries it
survived; a stall without the watchdog is only a delay. Then `run
--replicas 2` with every ported fault kind through both CLIs
(test_torch_chaos.py's one-world case). Exact equality throughout.

Deadlines sit far from both a real probe read and the injected stall, as
in tests/test_chaos.py: a real read (the JAX package's includes its
chunk's compute) is milliseconds, the stall seconds."""

import threading
import time

import pytest
import torch

from test_torch_chaos import _phold, cli_every_fault_kind
from test_torch_ensemble_cli import _ensemble_stats
from test_torch_slice import _assert_leaves_equal as assert_leaves_equal
from test_torch_slice import _jax_leaves as jax_leaves

from shadow_tpu.engine.ensemble import init_ensemble_state as j_init_ensemble_state
from shadow_tpu.engine.ensemble import run_ensemble_until as j_run_ensemble_until
from shadow_tpu.engine.round import WatchdogExpired as JWatchdogExpired
from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.runtime import chaos as jchaos
from shadow_tpu.runtime.recovery import RecoveryPolicy as JRecoveryPolicy
from shadow_tpu.runtime.recovery import run_until_recovering as j_run_until_recovering
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.engine.ensemble import init_ensemble_state, run_ensemble_until
from shadow_tpu_torch.engine import ensemble as port_ensemble
from shadow_tpu_torch.engine import round as port_round
from shadow_tpu_torch.engine.round import WatchdogExpired, _bounded, _fetch_probe, run_until
from shadow_tpu_torch.engine.state import state_to_host
from shadow_tpu_torch.runtime import chaos
from shadow_tpu_torch.runtime.recovery import RecoveryPolicy, run_until_recovering

END = 40 * NS_PER_MS
RPC = 4
DEADLINE_S = 1.0
STALL_S = 2.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WORLDS = {}


def _world(replicas):
    """(JAX start, runner factory maker, port start, runner factory maker)
    for one phold world (replicas 0) or an ensemble of it."""
    if replicas not in _WORLDS:
        jcfg, jm, jt, jst, cfg, model, tables, st0 = _phold()
        if replicas:
            jst = j_init_ensemble_state(jcfg, jm, replicas, 1)
            st0 = init_ensemble_state(cfg, model, replicas, 1, device="cpu")
            jrun, prun = j_run_ensemble_until, run_ensemble_until
        else:
            jrun, prun = j_run_until, run_until

        def maker(run, m, t, c):
            def watched(watchdog_s):
                def factory(rc=c):
                    def go(s, on_state=None):
                        return run(s, END, m, t, rc, rounds_per_chunk=RPC, on_state=on_state,
                                   watchdog_s=watchdog_s)
                    return go
                return factory
            return watched

        _WORLDS[replicas] = (jst, jcfg, maker(jrun, jm, jt, jcfg), st0, cfg,
                             maker(prun, model, tables, cfg))
    return _WORLDS[replicas]


def _recovering(mod_chaos, recovering, policy, st, cfg, factory, faults):
    plan = mod_chaos.FaultPlan(faults=faults)
    with mod_chaos.installed(plan):
        final, recs = recovering(st, END, cfg=cfg, policy=policy, runner_factory=factory)
    return final, recs, plan.report()


STALL_AT_1 = [{"kind": "stall", "at": 1, "stall_s": STALL_S}]
_JAX_STALLED = {}


def _jax_stalled(replicas):
    """The JAX package's run under STALL_AT_1 and the watchdog (final
    state, records, report), shared by the stall and slow-launch tests."""
    if replicas not in _JAX_STALLED:
        jst, jcfg, jmake = _world(replicas)[:3]
        _JAX_STALLED[replicas] = _recovering(
            jchaos, j_run_until_recovering,
            JRecoveryPolicy(max_recoveries=3, snapshot_interval_chunks=2),
            jst, jcfg, jmake(DEADLINE_S), STALL_AT_1)
    return _JAX_STALLED[replicas]


@pytest.mark.parametrize("replicas", [0, 2], ids=["single", "ensemble"])
def test_stall_under_the_watchdog_redispatches_like_the_reference(replicas):
    """A stall at chunk 1 blows the watchdog; the chunk is abandoned and
    re-dispatched from the retained snapshot. Same records (chunk,
    deadline, rollback point) and report; the port's final state is
    leaf-equal to the JAX package's."""
    st0, cfg, make = _world(replicas)[3:]
    jf, jrec, jrep = _jax_stalled(replicas)
    pf, prec, prep = _recovering(chaos, run_until_recovering,
                                 RecoveryPolicy(max_recoveries=3, snapshot_interval_chunks=2),
                                 st0, cfg, make(DEADLINE_S), STALL_AT_1)
    assert prec == jrec == [{"kind": "watchdog", "chunk": 1, "deadline_s": DEADLINE_S,
                             "replay_from_ns": 0}]
    assert prep == jrep == {"seed": 0, "planned": 1, "fired": [{"kind": "stall", "at": 1}]}
    assert_leaves_equal(jax_leaves(jf), state_to_host(pf))


@pytest.mark.parametrize("replicas", [0, 2], ids=["single", "ensemble"])
def test_slow_launch_under_the_watchdog_redispatches(replicas, monkeypatch):
    """The port's launch waits on its chunk's device work, so the
    watchdog's region starts with the launch: chunk 1's first round
    taking STALL_S (a wedged kernel, here a sleep in run_round) blows the
    deadline with no chaos plan installed. The records and the final
    state equal the JAX package's run under a stall at chunk 1, the same
    timeline as seen by the reference's watchdog."""
    st0, cfg, make = _world(replicas)[3:]
    mod = port_ensemble if replicas else port_round
    real, calls = mod.run_round, []

    def slow_run_round(*args, **kwargs):
        calls.append(None)
        if len(calls) == RPC + 1:  # chunk 0 has RPC live rounds
            time.sleep(STALL_S)
        return real(*args, **kwargs)

    monkeypatch.setattr(mod, "run_round", slow_run_round)
    jf, jrec, _ = _jax_stalled(replicas)
    pf, prec, prep = _recovering(chaos, run_until_recovering,
                                 RecoveryPolicy(max_recoveries=3, snapshot_interval_chunks=2),
                                 st0, cfg, make(DEADLINE_S), [])
    assert prec == jrec == [{"kind": "watchdog", "chunk": 1, "deadline_s": DEADLINE_S,
                             "replay_from_ns": 0}]
    assert prep["fired"] == []
    assert_leaves_equal(jax_leaves(jf), state_to_host(pf))


@pytest.mark.parametrize("replicas", [0, 2], ids=["single", "ensemble"])
def test_watchdog_budget_spent_fails_like_the_reference(replicas):
    """A persistent stall past the budget surfaces as WatchdogExpired with
    the reference's text, carrying the recoveries survived first."""
    jst, jcfg, jmake, st0, cfg, make = _world(replicas)
    faults = [{"kind": "stall", "stall_s": 0.2, "count": -1}]
    with pytest.raises(JWatchdogExpired) as want:
        _recovering(jchaos, j_run_until_recovering, JRecoveryPolicy(max_recoveries=1),
                    jst, jcfg, jmake(0.05), faults)
    with pytest.raises(WatchdogExpired) as got:
        _recovering(chaos, run_until_recovering, RecoveryPolicy(max_recoveries=1),
                    st0, cfg, make(0.05), faults)
    assert str(got.value) == str(want.value)
    assert (got.value.chunk, got.value.deadline_s) == (0, 0.05)
    assert got.value.recoveries == want.value.recoveries
    assert [r["kind"] for r in got.value.recoveries] == ["watchdog"]


@pytest.mark.parametrize("replicas", [0, 2], ids=["single", "ensemble"])
def test_stall_without_the_watchdog_is_only_a_delay(replicas):
    """Watchdog off: the stall delays chunk 1's probe read; the run has no
    recovery and ends leaf-equal to the JAX package's."""
    jst, jcfg, jmake, st0, cfg, make = _world(replicas)
    faults = [{"kind": "stall", "at": 1, "stall_s": 0.1}]
    jf, jrec, _ = _recovering(jchaos, j_run_until_recovering, JRecoveryPolicy(), jst, jcfg,
                              jmake(0.0), faults)
    pf, prec, prep = _recovering(chaos, run_until_recovering, RecoveryPolicy(), st0, cfg,
                                 make(0.0), faults)
    assert prec == jrec == []
    assert prep["fired"] == [{"kind": "stall", "at": 1}]
    assert_leaves_equal(jax_leaves(jf), state_to_host(pf))


def test_fetch_probe_deadline_and_stall():
    """The measured region starts before the stall seam: a stall past the
    deadline expires, one inside it returns the probe, and with the
    watchdog off nothing is measured."""
    probe = torch.arange(5, dtype=torch.int64)
    now = time.perf_counter
    assert _fetch_probe(probe, 0.0, 0, now()) == [0, 1, 2, 3, 4]
    assert _fetch_probe(probe, 5.0, 0, now()) == [0, 1, 2, 3, 4]
    with chaos.installed(chaos.FaultPlan(faults=[{"kind": "stall", "at": 3, "stall_s": 0.1}])):
        assert _fetch_probe(probe, 5.0, 3, now()) == [0, 1, 2, 3, 4]
    with chaos.installed(chaos.FaultPlan(faults=[{"kind": "stall", "at": 3, "stall_s": 0.1}])):
        with pytest.raises(WatchdogExpired, match="chunk 3 dispatch exceeded the 0.05s"):
            _fetch_probe(probe, 0.05, 3, now())
    assert str(WatchdogExpired(3, 0.05)) == str(JWatchdogExpired(3, 0.05))


def test_fetch_probe_region_starts_at_the_launch():
    """run_chunk passes the launch's start as `t0`: a read whose launch
    already took the deadline expires before it reads, one whose launch
    left time reads."""
    probe = torch.arange(3, dtype=torch.int64)
    assert _fetch_probe(probe, 5.0, 2, t0=time.perf_counter() - 1.0) == [0, 1, 2]
    with pytest.raises(WatchdogExpired, match="chunk 2 dispatch exceeded the 1s"):
        _fetch_probe(probe, 1.0, 2, t0=time.perf_counter() - 1.0)


def test_bounded_returns_raises_and_abandons():
    """_bounded gives back the work's value or raises its exception in the
    caller's thread, and abandons work still running at the deadline
    without waiting for it."""
    assert _bounded(lambda: 7, 5.0, time.perf_counter(), 0) == 7
    with pytest.raises(KeyError, match="boom"):
        _bounded(lambda: {}["boom"], 5.0, time.perf_counter(), 0)
    release = threading.Event()
    t0 = time.perf_counter()
    with pytest.raises(WatchdogExpired, match="chunk 4 dispatch"):
        _bounded(release.wait, 0.1, t0, 4)
    assert time.perf_counter() - t0 < 5.0
    release.set()


def test_cli_replicas_every_fault_kind_matches_shadow_tpu_run(tmp_path):
    """test_torch_chaos.py's every-kind `run` with `--replicas 2`: the
    ensemble runner's ladder, recovery and watchdog rungs, through both
    CLIs, to equal sim-stats."""
    cli_every_fault_kind(tmp_path, _ensemble_stats, ["--replicas", "2"])
