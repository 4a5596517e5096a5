"""Active-set compaction (active_lanes > 0: shadow_tpu_torch/engine/
round.py::compact_step around run_round's iteration body), dynamic
runahead (use_dynamic_runahead: round.py::_next_window_end) and
Draw.exponential_ns, held against the JAX package in the same mode:

  * compaction on tests/test_compact.py's worlds: tgen at 16 hosts with 8
    lanes (through the pump engine's twin at pump_k 3, with dynamic
    runahead on: the tgen world of both planes) and phold at 32 hosts
    with 6 lanes, leaf for leaf with `iters_done` and `lanes_live`; and
    against the port's own full-width run but for those two;
  * one compacted iteration with fewer eligible hosts than lanes
    (sentinel lanes, the world's last row among the live ones), pump
    stage and handler, against the reference's compact_step;
  * dynamic runahead on tests/test_dynamic_runahead.py's phold world;
  * an R = 2 phold ensemble with both planes on, against JAX's ensemble
    and against the port's single runs;
  * rng.exponential_ns and Draw.exponential_ns: the f32 Exp(1) draw
    within 1 ulp of the JAX package's (f32 log1p is not bit-identical
    across backends), the ns value within what that ulp moves.

Exact equality elsewhere."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_compact import _build_tgen, _lossy_graph
from test_dynamic_runahead import _setup as _dyn_setup
from test_torch_ensemble import port_world
from test_torch_slice import _assert_leaves_equal as assert_leaves_equal
from test_torch_slice import _jax_leaves as jax_leaves

from shadow_tpu import rng as j_rng
from shadow_tpu.engine import EngineConfig as JEngineConfig
from shadow_tpu.engine.ensemble import init_ensemble_state as j_init_ensemble_state
from shadow_tpu.engine.ensemble import run_ensemble_until as j_run_ensemble_until
from shadow_tpu.engine.round import Draw as JDraw
from shadow_tpu.engine.round import _next_window_end as j_next_window_end
from shadow_tpu.engine.round import bootstrap as j_bootstrap
from shadow_tpu.engine.round import compact_step as j_compact_step
from shadow_tpu.engine.round import handle_one_iteration as j_handle_one_iteration
from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.engine.state import init_state as j_init_state
from shadow_tpu.graph import compute_routing
from shadow_tpu.models.phold import PholdModel as JPholdModel
from shadow_tpu.simtime import NS_PER_MS, TIME_MAX
from shadow_tpu_torch import rng
from shadow_tpu_torch.engine.ensemble import (
    init_ensemble_state,
    replica_seeds,
    replica_slice,
    run_ensemble_until,
)
from shadow_tpu_torch.engine.round import (
    Draw,
    _next_window_end,
    bootstrap,
    compact_step,
    handle_one_iteration,
    run_until,
)
from shadow_tpu_torch.engine.state import (
    init_state,
    rows_view,
    state_from_numpy,
    state_to_numpy,
)
from shadow_tpu_torch.utils.tree import tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPE_LEAVES = (".iters_done", ".lanes_live")


def _without_shape(leaves: dict) -> dict:
    return {k: v for k, v in leaves.items() if k not in SHAPE_LEAVES}


def _tgen16(lanes: int):
    """test_compact.py's tgen world at 16 hosts (8 lossy nodes, shaped),
    through the pump engine at pump_k 3 with dynamic runahead."""
    jcfg, jm, jt, jst = _build_tgen(16, lanes)
    jcfg = dataclasses.replace(jcfg, engine="pump", pump_k=3, use_dynamic_runahead=True,
                               tracker=True)
    return jcfg, jm, jt, jst


def _phold32(lanes: int):
    """test_compact.py's phold world: 32 hosts on the 8-node lossy graph."""
    graph = _lossy_graph()
    jt = compute_routing(graph, block=16).with_hosts([i % 8 for i in range(32)])
    jcfg = JEngineConfig(num_hosts=32, queue_capacity=64, runahead_ns=graph.min_latency_ns(),
                         seed=3, max_iters_per_round=100_000, active_lanes=lanes, tracker=True)
    jm = JPholdModel(num_hosts=32)
    return jcfg, jm, jt, j_bootstrap(j_init_state(jcfg, jm.init()), jm, jcfg)


def _dyn_phold():
    """test_dynamic_runahead.py's world: 8 phold hosts on nodes 0 and 1
    (20 ms apart and to themselves); the graph's 1 ms minimum belongs to
    nodes no host sits on."""
    graph, jt = _dyn_setup()
    jcfg = JEngineConfig(num_hosts=8, queue_capacity=32, runahead_ns=graph.min_latency_ns(),
                         use_dynamic_runahead=True, tracker=True)
    jm = JPholdModel(num_hosts=8, min_delay_ns=NS_PER_MS, max_delay_ns=5 * NS_PER_MS)
    return jcfg, jm, jt, j_bootstrap(j_init_state(jcfg, jm.init()), jm, jcfg)


# name: (world, end, rounds per chunk)
RUNS = {
    "tgen16-lanes8-pump-dynamic": (lambda: _tgen16(8), 100 * NS_PER_MS, 16),
    "phold32-lanes6": (lambda: _phold32(6), 150 * NS_PER_MS, 16),
    "phold8-dynamic": (lambda: _dyn_phold(), 1_000 * NS_PER_MS, 16),
}
_RUNS = {}


def _run(name):
    """The JAX package's run, the port's, and the port's with compaction
    off (the same world at full width)."""
    if name not in _RUNS:
        build, end, rpc = RUNS[name]
        jcfg, jm, jt, jst = build()
        jout = j_run_until(jst, end, jm, jt, jcfg, rounds_per_chunk=rpc)
        cfg, model, tables = port_world(jcfg, jm, jt)
        st0 = state_from_numpy(jax_leaves(jst))
        out = run_until(st0, end, model, tables, cfg, rounds_per_chunk=rpc)
        full = None
        if cfg.active_lanes:
            full = run_until(st0, end, model, tables,
                             dataclasses.replace(cfg, active_lanes=0), rounds_per_chunk=rpc)
        _RUNS[name] = dict(jax=jax_leaves(jout), port=state_to_numpy(out),
                           full=None if full is None else state_to_numpy(full))
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(RUNS))
def test_port_planes_run_matches_jax(name):
    """Every leaf, iters_done and lanes_live included."""
    run = _run(name)
    assert run["jax"][".events_handled"].sum() > 0
    assert run["jax"][".packets_sent"].sum() > 0
    assert_leaves_equal(run["jax"], run["port"])
    if "dynamic" in name:
        # a packet flew, and the windows grew past the configured runahead
        assert run["port"][".min_used_lat"] < TIME_MAX
        assert run["port"][".min_used_lat"] == run["jax"][".min_used_lat"]
        assert run["port"][".now"] == run["jax"][".now"]


@pytest.mark.parametrize("name", [n for n in sorted(RUNS) if "lanes" in n])
def test_port_compact_run_equals_full_width(name):
    """Compaction changes only how iterations split: every leaf but
    iters_done and lanes_live equals the full-width run's. phold32's
    windows hold more eligible hosts than its 6 lanes, so its compacted
    run takes more iterations; tgen16's hold at most 8 (clients and
    servers take turns), so most of its iterations carry sentinel lanes."""
    run = _run(name)
    assert_leaves_equal(_without_shape(run["full"]), _without_shape(run["port"]))
    more = run["port"][".iters_done"].sum() - run["full"][".iters_done"].sum()
    assert more > 0 if name.startswith("phold") else more >= 0


def test_port_dynamic_window_is_the_used_latency():
    """On the dynamic phold world the window grows to the 20 ms the hosts'
    paths use, not the graph's 1 ms minimum: the run covers its second in
    about fifty rounds."""
    run = _run("phold8-dynamic")
    assert int(run["port"][".min_used_lat"]) == 20 * NS_PER_MS
    assert int(run["port"][".tracker.rounds_live"]) < 60


def test_port_compact_step_with_sentinel_lanes_matches_jax():
    """One compacted handler iteration on the bootstrapped phold32 world
    (dynamic runahead on, so packets fold into min_used_lat) with fewer
    eligible hosts than lanes: sentinel lanes gather the world's last row,
    itself eligible. Every leaf equals the reference's compact_step around
    its handler; the tgen16 run above takes the pump stage through such
    iterations too."""
    jcfg, jm, jt, jst = _phold32(0)
    jcfg = dataclasses.replace(jcfg, use_dynamic_runahead=True)
    cfg, model, tables = port_world(jcfg, jm, jt)
    nt = np.asarray(jst.queue.head_time)
    h = nt.shape[0]
    we = int(nt[h - 1]) + 1
    elig = int((nt < we).sum())
    assert 0 < elig < h - 3
    lanes = elig + 3

    def jbody(s):
        return j_handle_one_iteration(s, jnp.int64(we), jm, jt, jcfg)

    def body(s):
        return handle_one_iteration(s, torch.tensor(we), model, tables, cfg)

    want = jax.jit(lambda s: j_compact_step(s, jnp.int64(we), lanes, jbody))(jst)
    got = compact_step(state_from_numpy(jax_leaves(jst)), torch.tensor(we), lanes, body)
    assert_leaves_equal(jax_leaves(want), state_to_numpy(got))
    assert int(np.asarray(want.events_handled).sum()) == elig
    assert int(want.min_used_lat) < TIME_MAX


def test_port_next_window_end_dynamic_matches_jax():
    """The window math alone, before and after a packet has flown, on the
    dynamic phold world: a scalar window, and [R] windows on an
    ensemble's rows from each replica's own min_used_lat."""
    jcfg, jm, jt, jst = _dyn_phold()
    cfg, model, tables = port_world(jcfg, jm, jt)
    end = 10**9
    used = (TIME_MAX, 20 * NS_PER_MS, 3)
    want = []
    for u in used:
        s = jst.replace(min_used_lat=jnp.int64(u))
        start = jnp.min(s.queue.head_time)
        want.append(int(j_next_window_end(s, jnp.int64(end), jcfg, None, start=start,
                                          tables=jt)))
        t = state_from_numpy(jax_leaves(s))
        assert int(_next_window_end(t, end, cfg, t.queue.head_time.amin(), tables)) == want[-1]
    first = int(jnp.min(jst.queue.head_time))
    assert want == [first + NS_PER_MS, first + 20 * NS_PER_MS, first + NS_PER_MS]
    one = state_from_numpy(jax_leaves(jst))
    rows = rows_view(tree_map(lambda *xs: torch.stack(xs), *[one] * len(used)))
    rows.min_used_lat = torch.tensor(used, dtype=torch.int64)
    start = rows.queue.head_time.reshape(len(used), -1).amin(dim=1)
    assert _next_window_end(rows, end, cfg, start, tables).tolist() == want


ENS_R, ENS_STRIDE, ENS_END, ENS_RPC, ENS_LANES = 2, 5, 400 * NS_PER_MS, 8, 3


def _ensemble():
    if "ensemble" not in _RUNS:
        jcfg, jm, jt, _ = _dyn_phold()
        jcfg = dataclasses.replace(jcfg, active_lanes=ENS_LANES)
        cfg, model, tables = port_world(jcfg, jm, jt)
        jens = j_run_ensemble_until(j_init_ensemble_state(jcfg, jm, ENS_R, ENS_STRIDE), ENS_END,
                                    jm, jt, jcfg, rounds_per_chunk=ENS_RPC)
        ens = run_ensemble_until(
            init_ensemble_state(cfg, model, ENS_R, ENS_STRIDE, device="cpu"), ENS_END, model,
            tables, cfg, rounds_per_chunk=ENS_RPC)
        singles = []
        for seed in replica_seeds(cfg, ENS_R, ENS_STRIDE):
            c = dataclasses.replace(cfg, seed=seed)
            st = bootstrap(init_state(c, model.init("cpu"), device="cpu"), model, c)
            singles.append(state_to_numpy(run_until(st, ENS_END, model, tables, c,
                                                    rounds_per_chunk=ENS_RPC)))
        _RUNS["ensemble"] = dict(jax=jax_leaves(jens), port=ens, singles=singles)
    return _RUNS["ensemble"]


def test_port_compact_dynamic_ensemble_matches_jax():
    run = _ensemble()
    assert run["jax"][".events_handled"].sum() > 0
    assert (run["jax"][".min_used_lat"] < TIME_MAX).all()
    assert_leaves_equal(run["jax"], state_to_numpy(run["port"]))


@pytest.mark.parametrize("replica", range(ENS_R))
def test_port_compact_dynamic_ensemble_replica_matches_single_run(replica):
    run = _ensemble()
    assert_leaves_equal(run["singles"][replica],
                        state_to_numpy(replica_slice(run["port"], replica)))


MEAN_NS = 2_500_000


def _f32_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in f32 units in the last place between two arrays of
    non-negative f32 values."""
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_port_exponential_ns_within_one_ulp_of_jax():
    """4,096 hosts x 4 draws: the f32 Exp(1) draw of the port within 1 ulp
    of the JAX package's; where they are equal the ns values are equal,
    elsewhere within mean_ns x the draw's ulp (+1 for the truncation)."""
    jkeys = j_rng.host_keys(7, 4096)
    keys = torch.from_numpy(np.asarray(jax.random.key_data(jkeys)).astype(np.int64))
    for c in (0, 1, 17, 2**32 - 1):
        ctr = np.full(4096, c, np.uint32)
        u = np.asarray(j_rng.uniform_f32(jkeys, jnp.asarray(ctr)))
        want_draw = np.asarray(-jnp.log1p(-jnp.asarray(u)))
        want = np.asarray(j_rng.exponential_ns(jkeys, jnp.asarray(ctr), MEAN_NS))
        tctr = torch.from_numpy(ctr.astype(np.int64))
        got_draw = (-torch.log1p(-rng.uniform_f32(keys, tctr))).numpy()
        got = rng.exponential_ns(keys, tctr, MEAN_NS).numpy()
        assert (_f32_ulps(want_draw, got_draw) <= 1).all()
        same = want_draw == got_draw
        np.testing.assert_array_equal(got[same], want[same])
        ulp = np.spacing(np.maximum(want_draw, got_draw)).astype(np.float64)
        assert (np.abs(got - want) <= np.ceil(ulp * MEAN_NS) + 1).all()
        assert want.min() >= 0 and 0.5 * MEAN_NS < want.mean() < 1.5 * MEAN_NS
        # Draw.exponential_ns(i) is rng.exponential_ns at counter + i
        jdraw = np.asarray(JDraw(jkeys, jnp.asarray(ctr)).exponential_ns(3, MEAN_NS))
        tdraw = Draw(keys, tctr).exponential_ns(3, MEAN_NS).numpy()
        np.testing.assert_array_equal(
            jdraw, np.asarray(j_rng.exponential_ns(jkeys, jnp.asarray(ctr + np.uint32(3)),
                                                   MEAN_NS)))
        np.testing.assert_array_equal(
            tdraw, rng.exponential_ns(keys, (tctr + 3) & rng.MASK32, MEAN_NS).numpy())
        assert (np.abs(tdraw - jdraw) <= np.ceil(ulp.max() * MEAN_NS) + 1).all()

