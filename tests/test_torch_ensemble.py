"""The ensemble plane (shadow_tpu_torch/engine/ensemble.py): R seeded
replicas of one world run as one batch. Held against the JAX package's
ensemble (its run_ensemble_until under vmap, which runs its XLA pump
where the megakernel is asked for; the port runs the kernel's twin on
the CPU) and against the port's own single runs with the derived seeds,
on the reference tests' worlds (tests/test_pipeline.py::_phold_world
here; tests/test_pump.py::_world in test_torch_ensemble_tgen.py, the
onion world of tests/test_overlay.py in test_torch_ensemble_onion.py).
Also: replica_keys, the initial stacks, a ragged host count, replicas
that quiesce in different chunks, a capacity error naming its replica,
the stack's numpy round trip, and the handler pass limited to some rows
(what the per-replica done-mask rests on). Exact equality throughout."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_pipeline import _phold_world
from test_pump import _world as _tgen_world
from test_torch_models import chip_smoke, jax_leaves, port_model, small_worlds, worlds
from test_torch_slice import _assert_leaves_equal as assert_leaves_equal

from shadow_tpu import rng as j_rng
from shadow_tpu.engine.ensemble import init_ensemble_state as j_init_ensemble_state
from shadow_tpu.engine.ensemble import run_ensemble_until as j_run_ensemble_until
from shadow_tpu.engine.round import CapacityError as JCapacityError
from shadow_tpu.netstack import bw_bits_per_sec_to_refill
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch import equeue, rng
from shadow_tpu_torch.engine import megakernel as mk
from shadow_tpu_torch.engine.ensemble import (
    init_ensemble_state,
    num_replicas,
    replica_seeds,
    replica_slice,
    run_ensemble_until,
)
from shadow_tpu_torch.engine.round import (
    CapacityError,
    bootstrap,
    handle_one_iteration,
    run_until,
)
from shadow_tpu_torch.engine.state import (
    EngineConfig,
    init_state,
    rows_view,
    stacked_view,
    state_from_numpy,
    state_to_numpy,
)
from shadow_tpu_torch.graph.routing import RoutingTables
from shadow_tpu_torch.models.overlay import OnionModel
from shadow_tpu_torch.models.tgen import TgenModel
from shadow_tpu_torch.utils.tree import tree_leaves_with_path


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BW = bw_bits_per_sec_to_refill(20_000_000)


def port_world(jcfg, jmodel, jtables):
    """The port's config, model and tables with every field of the JAX
    package's."""
    cfg = EngineConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    if type(jmodel).__name__ == "TgenModel":
        model = TgenModel(**{f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)})
    else:
        model = port_model(jmodel)
    tables = RoutingTables(
        **{f: torch.from_numpy(np.asarray(getattr(jtables, f)).copy())
           for f in ("lat_ns", "rel", "host_node", "lookahead_ns")}
    )
    return cfg, model, tables


def single_run(cfg, model, tables, seed, end, rounds_per_chunk, bw=None):
    """A single-world port run exactly as a user with this seed runs it."""
    rcfg = dataclasses.replace(cfg, seed=seed)
    st = bootstrap(init_state(rcfg, model.init("cpu"), bw, bw, device="cpu"), model, rcfg)
    return run_until(st, end, model, tables, rcfg, rounds_per_chunk=rounds_per_chunk)


# --- worlds: (JAX cfg, model, tables), the port's, replicas, stride, end,
# rounds per chunk, per-host byte rate (shaping) ---
def _phold(seed=11, **kw):
    jcfg, jm, jt, _ = _phold_world(seed=seed, **kw)
    return dataclasses.replace(jcfg, tracker=True), jm, jt


def _tgen(hosts, engine, k):
    jcfg, jm, jt, _ = _tgen_world(hosts, 0.02, 20_000_000, seed=3)
    return dataclasses.replace(jcfg, tracker=True, engine=engine, pump_k=k), jm, jt


WORLDS = {
    # name: (world, replicas, stride, end, rounds per chunk, shaped)
    "phold": (lambda: _phold(seed=11), 3, 7, 40 * NS_PER_MS, 4, False),
    # to 80 ms: by then loss draws have dropped packets in one replica
    "tgen-plain": (lambda: _tgen(8, "plain", 0), 2, 3, 80 * NS_PER_MS, 8, True),
    "tgen-pump": (lambda: _tgen(8, "pump", 3), 2, 3, 80 * NS_PER_MS, 8, True),
    # one round per chunk: replica 1 (seed 13) goes quiet six chunks
    # before replica 0 (seed 11)
    "phold-quiesce": (lambda: _phold(seed=11), 2, 2, 40 * NS_PER_MS, 1, False),
}
_RUNS = {}


def _run(name):
    """The JAX ensemble, the port's ensemble (with its probe lines) and
    the port's single runs of one world, computed once."""
    if name not in _RUNS:
        build, r, stride, end, rpc, shaped = WORLDS[name]
        jcfg, jm, jt = build()
        cfg, model, tables = port_world(jcfg, jm, jt)
        bw = BW if shaped else None
        jens = j_run_ensemble_until(
            j_init_ensemble_state(jcfg, jm, r, stride, bw, bw), end, jm, jt, jcfg,
            rounds_per_chunk=rpc)
        rows = []
        ens = run_ensemble_until(
            init_ensemble_state(cfg, model, r, stride, bw, bw, device="cpu"), end, model,
            tables, cfg, rounds_per_chunk=rpc, on_rows=rows.append)
        singles = [state_to_numpy(single_run(cfg, model, tables, s, end, rpc, bw))
                   for s in replica_seeds(cfg, r, stride)]
        _RUNS[name] = dict(jax=jax_leaves(jens), port=ens, rows=rows, singles=singles,
                           end=end)
    return _RUNS[name]


@pytest.mark.parametrize("seed,replicas,hosts,stride", [
    (1, 1, 5, 1), (7, 3, 4, 2), (2**33 + 5, 4, 3, 7), (0, 2, 9, 1)])
def test_replica_keys_match_jax(seed, replicas, hosts, stride):
    got = rng.replica_keys(seed, replicas, hosts, stride)
    want = np.asarray(jax.random.key_data(j_rng.replica_keys(seed, replicas, hosts, stride)))
    assert got.shape == (replicas, hosts, 2)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    for r in range(replicas):
        assert torch.equal(got[r], rng.host_keys(seed + r * stride, hosts))


@pytest.mark.parametrize("replicas,stride", [(0, 1), (2, 0)])
def test_replica_keys_refuse_like_jax(replicas, stride):
    with pytest.raises(ValueError) as want:
        j_rng.replica_keys(3, replicas, 4, stride)
    with pytest.raises(ValueError) as got:
        rng.replica_keys(3, replicas, 4, stride)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["phold", "tgen-pump"])
def test_initial_stack_matches_jax(name):
    build, r, stride, _, _, shaped = WORLDS[name]
    jcfg, jm, jt = build()
    cfg, model, _ = port_world(jcfg, jm, jt)
    bw = BW if shaped else None
    want = jax_leaves(j_init_ensemble_state(jcfg, jm, r, stride, bw, bw))
    got = init_ensemble_state(cfg, model, r, stride, bw, bw, device="cpu")
    assert num_replicas(got) == r and got.queue.time.shape[:2] == (r, cfg.num_hosts)
    assert_leaves_equal(want, state_to_numpy(got))


@pytest.mark.parametrize("name", ["phold", "phold-quiesce"])
def test_ensemble_matches_jax(name):
    run = _run(name)
    assert run["jax"][".events_handled"].sum() > 0
    assert_leaves_equal(run["jax"], state_to_numpy(run["port"]))


@pytest.mark.parametrize("name", ["phold", "phold-quiesce"])
def test_replicas_match_single_runs(name):
    run = _run(name)
    singles = run["singles"]
    for r, single in enumerate(singles):
        assert_leaves_equal(single, state_to_numpy(replica_slice(run["port"], r)))
    # the seeds diverged the trajectories
    a, b = singles[0], singles[1]
    assert any(not np.array_equal(a[k], b[k]) for k in a if k != ".rng_key")


def test_replicas_quiesce_in_different_chunks():
    """In this world the replicas go quiet in different chunks, so the
    earlier one takes idle rounds while the other drains, and the driver
    restores its `now` and round counters to its own quiescence chunk's
    (the result is checked leaf-exact above); here the straddle and the
    restore are asserted."""
    from shadow_tpu_torch.engine.round import PROBE_FIELDS

    run = _run("phold-quiesce")
    idle = PROBE_FIELDS.index("rounds_idle")
    nt = np.stack([rows[:, 0] for rows in run["rows"]])  # [chunks, R]
    first_quiet = [int(np.argmax(nt[:, r] >= run["end"])) for r in range(nt.shape[1])]
    assert all(nt[first_quiet[r], r] >= run["end"] for r in range(nt.shape[1]))
    early = int(np.argmin(first_quiet))
    assert first_quiet[early] < max(first_quiet)
    assert run["rows"][-1][early, idle] > run["rows"][first_quiet[early]][early, idle]
    final_idle = run["port"].tracker.rounds_idle[early]
    assert int(final_idle) == run["rows"][first_quiet[early]][early, idle]


def test_ragged_batch_matches_single_runs():
    """A host count that is not a multiple of the rows a kernel warp owns
    (13), R = 3, through the megakernel engine: each replica equals its
    single run."""
    hosts, r, stride, end = 13, 3, 2, 40 * NS_PER_MS
    assert hosts % mk.ROWS_PER_WARP != 0
    cfg, model, tables = port_world(*_tgen(hosts, "megakernel", 3))
    counters = {}
    ens = run_ensemble_until(
        init_ensemble_state(cfg, model, r, stride, BW, BW, device="cpu"), end, model, tables,
        cfg, rounds_per_chunk=8, counters=counters)
    assert counters["iters"] > 0
    for i, seed in enumerate(replica_seeds(cfg, r, stride)):
        single = state_to_numpy(single_run(cfg, model, tables, seed, end, 8, BW))
        assert single[".packets_dropped"].sum() > 0
        assert_leaves_equal(single, state_to_numpy(replica_slice(ens, i)))


def test_capacity_error_names_the_replica_like_jax():
    jcfg, jm, jt = _phold(seed=11, queue_capacity=2)
    jcfg = dataclasses.replace(jcfg, outbox_capacity=1)
    cfg, model, tables = port_world(jcfg, jm, jt)
    end = 40 * NS_PER_MS
    with pytest.raises(JCapacityError) as want:
        j_run_ensemble_until(j_init_ensemble_state(jcfg, jm, 3, 1), end, jm, jt, jcfg,
                             rounds_per_chunk=4)
    with pytest.raises(CapacityError, match=r"replica \d of 3") as got:
        run_ensemble_until(init_ensemble_state(cfg, model, 3, 1, device="cpu"), end, model,
                           tables, cfg, rounds_per_chunk=4)
    assert got.value.replica == want.value.replica
    assert (got.value.queue_overflow, got.value.outbox_overflow) == (
        want.value.queue_overflow, want.value.outbox_overflow)


def test_stack_crosses_to_numpy_and_back():
    """An [R, ...] stack (and its rows view) round-trips through
    state_to_numpy / state_from_numpy, the form the JAX package's
    stacked state crosses in."""
    cfg, model, _ = port_world(*_tgen(8, "pump", 3))
    ens = init_ensemble_state(cfg, model, 3, 2, BW, BW, device="cpu")
    leaves = state_to_numpy(ens)
    assert leaves[".now"].shape == (3,) and leaves[".rng_key"].shape == (3, 8, 2)
    back = state_from_numpy(leaves)
    assert_leaves_equal(leaves, state_to_numpy(back))
    rows = rows_view(back)
    assert rows.queue.time.shape == (24, cfg.queue_capacity) and rows.now.shape == (3,)
    assert rows.queue.time.data_ptr() == back.queue.time.data_ptr()  # a view
    assert_leaves_equal(leaves, state_to_numpy(stacked_view(rows)))


@pytest.mark.parametrize("name", ["phold", "bulk-tcp", "cdn", "gossip", "onion", "tgen"])
def test_handler_pass_leaves_unselected_rows_alone(name):
    """handle_one_iteration limited to some rows (a replica that did not
    reject, or one already drained) changes nothing in the other rows,
    and in the selected rows does what the full pass does."""
    if name == "tgen":
        cfg, model, tables, st = chip_smoke.lossy_world(12, torch.device("cpu"))
    elif name == "onion":
        model = OnionModel(num_hosts=12, num_clients=5, num_relays=7)
        cfg_kw = dict(queue_capacity=192, outbox_capacity=64, seed=9, tracker=True)
        _, (cfg, tables, st) = worlds(model, 0.02, chip_smoke.tri_node_gml(0.02),
                                      [i % 3 for i in range(12)], cfg_kw)
    else:
        (_, jm, _, _), (cfg, tables, st) = small_worlds(name)
        model = port_model(jm)
    st = run_until(st, 30 * NS_PER_MS, model, tables, cfg, rounds_per_chunk=4)
    # a window wide enough that both halves of the rows hold events
    we = equeue.next_time(st.queue).amin() + 20 * NS_PER_MS
    h = st.num_hosts
    rows = torch.arange(h) % 2 == 0
    elig = equeue.next_time(st.queue) < we
    assert bool((elig & rows).any()) and bool((elig & ~rows).any())
    full = handle_one_iteration(st.clone(), we, model, tables, cfg)
    part = handle_one_iteration(st.clone(), we, model, tables, cfg, rows=rows)
    for (path, a), (_, b), (_, c) in zip(tree_leaves_with_path(st), tree_leaves_with_path(part),
                                         tree_leaves_with_path(full)):
        if a.ndim == 0 or a.shape[0] != h:
            continue
        assert torch.equal(b[~rows], a[~rows]), path
        assert torch.equal(b[rows], c[rows]), path


def test_check_capacity_names_the_replica():
    """check_capacity on a stacked state (and on its rows view) names the
    first replica whose queue or outbox overflowed."""
    from shadow_tpu_torch.engine.round import check_capacity

    cfg, model, _ = port_world(*_phold(seed=11))
    ens = init_ensemble_state(cfg, model, 3, 1, device="cpu")
    check_capacity(ens)
    ens.outbox.overflow[2, 1] = 4
    ens.queue.overflow[1, 0] = 1
    for st in (ens, rows_view(ens)):
        with pytest.raises(CapacityError, match=r"replica 1 of 3 \(\+1 more") as err:
            check_capacity(st)
        assert err.value.replica == 1 and err.value.queue_overflow == 1


def test_ensemble_keeps_the_kernel_engine():
    """ensemble_engine_cfg marks the config and changes no engine: "auto"
    still resolves to the kernel on the card (the reference falls back
    to its XLA pump under vmap; the port has no fallback)."""
    from shadow_tpu_torch.engine.ensemble import ensemble_engine_cfg
    from shadow_tpu_torch.engine.round import effective_engine

    cfg, _, _ = port_world(*_tgen(8, "auto", 0))
    ens = ensemble_engine_cfg(cfg)
    assert ens.ensemble and dataclasses.replace(ens, ensemble=False) == cfg
    assert effective_engine(ens, "cuda") == "megakernel"
    assert effective_engine(ens, "cpu") == "plain"


def test_exchange_counts_grid_overflow_on_each_replicas_first_row():
    """The exchange's delivery grid drops arrivals past deliver_lanes and
    counts them on row 0; on an ensemble's rows, on the first row of the
    replica they arrive in, as the reference's vmap counts them."""
    q = equeue.create(6, 4)  # 2 replicas of 3 hosts
    dst = torch.tensor([4, 4, 4, 1, 2, 0])
    n = dst.shape[0]
    args = dict(valid=torch.ones(n, dtype=torch.bool), time=torch.arange(n) + 10,
                tie=torch.arange(n), kind=torch.zeros(n, dtype=torch.int32),
                data=torch.zeros((n, equeue.PAYLOAD_LANES), dtype=torch.int32),
                deliver_lanes=2)
    out = equeue.push_many_sorted(q, dst, rows_per_world=3, **args)
    assert out.overflow.tolist() == [0, 0, 0, 1, 0, 0]
    assert out.count.tolist() == [1, 1, 1, 0, 2, 0]
    assert equeue.push_many_sorted(q, dst, **args).overflow.tolist() == [1, 0, 0, 0, 0, 0]
