"""The module that holds the pump megakernel (shadow_tpu_torch/engine/
megakernel.py). On the CPU, megakernel_stage runs the kernel's plain twin
(engine/pump.py::pump_stage); one stage must equal the JAX package's
megakernel_stage (Pallas interpret mode) leaf for leaf, including the
rejected flag, on a mid-run state where P1, P2 and P3 all fire. The
mid-run state comes from the JAX megakernel engine on the world and
config of tests/test_torch_slice.py, so the two files share that run's
compile. The CUDA kernel itself runs only on the card (the `cuda`-marked
test; chip_smoke.py holds it against the twin at full width, also on
states built to reach the kernel's edges). Here those states' construction
is checked, and the twin is held against the JAX package's pump_stage on
two of them. Exact equality throughout."""

import dataclasses
import pathlib
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pump import _world

from shadow_tpu.engine.megakernel import megakernel_stage as j_megakernel_stage
from shadow_tpu.engine.pump import pump_stage as j_pump_stage
from shadow_tpu.engine.round import _next_window_end as j_next_window_end
from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.engine import megakernel as mk
from shadow_tpu_torch.engine.pump import pump_stage
from shadow_tpu_torch.config.options import NotYetPorted
from shadow_tpu_torch.engine.round import effective_engine, run_until
from shadow_tpu_torch.engine.state import EngineConfig, state_from_numpy, state_to_numpy
from shadow_tpu_torch.graph.routing import RoutingTables
from shadow_tpu_torch.models.overlay import OnionModel
from shadow_tpu_torch.models.tgen import TGEN_TCP, TgenModel
from shadow_tpu_torch.simtime import TIME_MAX


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run next to other test processes (pytest-xdist): keep
    torch to one intra-op thread so they do not crowd the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the smoke's worlds and edge-case states)
HOSTS = 16
MID_RUN_NS = 10 * NS_PER_MS  # P1, P2 and P3 all fire in the next stage
PUMP_K = 2


def _jax_leaves(st) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(st):
        if jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            leaf = jax.random.key_data(leaf)
        out[jax.tree_util.keystr(path)] = np.asarray(leaf)
    return out


def _jax_state(template, leaves: dict):
    """`template` (a JAX SimState) with every leaf replaced by the array
    of the same path in `leaves` (state_to_numpy's keys)."""
    def put(path, leaf):
        x = jnp.asarray(leaves[jax.tree_util.keystr(path)])
        if jnp.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            return jax.random.wrap_key_data(x, impl=jax.random.key_impl(leaf))
        return x
    return jax.tree_util.tree_map_with_path(put, template)


def _port_world(cfg, model, tables):
    tcfg = EngineConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    tmodel = TgenModel(
        num_hosts=model.num_hosts, num_clients=model.num_clients,
        num_servers=model.num_servers, req_bytes=model.req_bytes,
        resp_bytes=model.resp_bytes, pause_ns=model.pause_ns, port=model.port,
        start_ns=model.start_ns,
    )
    ttables = RoutingTables(
        **{f: torch.from_numpy(np.asarray(getattr(tables, f)).copy())
           for f in ("lat_ns", "rel", "host_node", "lookahead_ns")}
    )
    return tcfg, tmodel, ttables


def _assert_leaves_equal(want: dict, got: dict):
    assert sorted(want) == sorted(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module")
def mid_run():
    cfg, model, tables, st0 = _world(HOSTS, 0.02, 20_000_000)
    cfg = dataclasses.replace(cfg, engine="megakernel", pump_k=PUMP_K, tracker=True)
    st = j_run_until(st0, MID_RUN_NS, model, tables, cfg, rounds_per_chunk=16)
    we = j_next_window_end(st, jnp.asarray(10**9, jnp.int64), cfg, None, tables=tables)
    return cfg, model, tables, st, we


def test_one_stage_matches_jax_megakernel(mid_run):
    cfg, model, tables, st, we = mid_run
    want, want_rej = jax.jit(
        lambda s, w: j_megakernel_stage(s, w, model, tables, cfg)
    )(st, we)

    tcfg, tmodel, ttables = _port_world(cfg, model, tables)
    tst = state_from_numpy(_jax_leaves(st))
    tw = torch.tensor(int(we))
    # the class tallies of this stage, from the twin (whose result is held
    # leaf-equal to the JAX kernel's just below)
    tallies = []
    pump_stage(tst.clone(), tw, tmodel, ttables, tcfg, debug_out=tallies)
    taken = {k: sum(d[k] for d in tallies) for k in ("p1", "p2", "p3")}
    assert all(v > 0 for v in taken.values()), taken

    got, got_rej = mk.megakernel_stage(tst, tw, tmodel, ttables, tcfg)
    assert bool(got_rej) == bool(want_rej)
    _assert_leaves_equal(_jax_leaves(want), state_to_numpy(got))


def test_cpu_stage_is_the_twin_and_counts_no_launch(mid_run):
    cfg, model, tables, st, we = mid_run
    tcfg, tmodel, ttables = _port_world(cfg, model, tables)
    tst = state_from_numpy(_jax_leaves(st))
    before = mk.PUMP_KERNEL.launches
    a, rej_a = mk.megakernel_stage(tst.clone(), torch.tensor(int(we)), tmodel, ttables, tcfg)
    b, rej_b = pump_stage(tst.clone(), torch.tensor(int(we)), tmodel, ttables, tcfg)
    assert mk.PUMP_KERNEL.launches == before
    assert bool(rej_a) == bool(rej_b)
    _assert_leaves_equal(state_to_numpy(b), state_to_numpy(a))


def test_kernel_args_validate_every_leaf(mid_run):
    """The wrapper's checks (device, dtype, shape, contiguity) run on the
    CPU too; a bad leaf raises instead of reaching the kernel."""
    cfg, model, tables, st, we = mid_run
    tcfg, tmodel, ttables = _port_world(cfg, model, tables)
    tst = state_from_numpy(_jax_leaves(st))
    rej = torch.zeros((1,), dtype=torch.int32)
    args, _ = mk.kernel_args(tst, torch.tensor(int(we)), tmodel, ttables, tcfg, rej,
                             mk.PUMP_KERNEL.codel_table("cpu"))
    assert (args.H, args.Q, args.pump_k, args.S, args.R) == (
        HOSTS, tst.queue.time.shape[1], PUMP_K, 4, 4)
    bad = dataclasses.replace(tst, seq=tst.seq.to(torch.int32))
    with pytest.raises(ValueError, match="seq"):
        mk.kernel_args(bad, torch.tensor(int(we)), tmodel, ttables, tcfg, rej,
                       mk.PUMP_KERNEL.codel_table("cpu"))
    q = tst.queue
    strided = dataclasses.replace(q, time=q.time.t().contiguous().t())
    with pytest.raises(ValueError, match="q_time"):
        mk.kernel_args(dataclasses.replace(tst, queue=strided), torch.tensor(int(we)),
                       tmodel, ttables, tcfg, rej, mk.PUMP_KERNEL.codel_table("cpu"))
    # a library per TCP shape up to MAX_TCP_SHAPE: a shape within it is
    # taken (its leaves checked at its ranges: this state's ooo and sacked
    # hold TGEN_TCP's 4), a shape past it refused with the limit named
    r_max, s_max = mk.MAX_TCP_SHAPE
    for shape in ({"ooo_ranges": r_max + 1}, {"segs_per_flush": s_max + 1}):
        other = dataclasses.replace(tmodel, tcp_params=dataclasses.replace(TGEN_TCP, **shape))
        with pytest.raises(NotYetPorted, match=f"1 to {r_max} ranges and 1 to {s_max} segments"):
            mk.kernel_args(tst, torch.tensor(int(we)), other, ttables, tcfg, rej,
                           mk.PUMP_KERNEL.codel_table("cpu"))
    wide_segs = dataclasses.replace(TGEN_TCP, segs_per_flush=s_max)
    args, _ = mk.kernel_args(tst, torch.tensor(int(we)),
                             dataclasses.replace(tmodel, tcp_params=wide_segs), ttables, tcfg,
                             rej, mk.PUMP_KERNEL.codel_table("cpu"))
    assert (args.R, args.segs_per_flush) == (4, s_max)
    more_ranges = dataclasses.replace(TGEN_TCP, ooo_ranges=r_max)
    with pytest.raises(ValueError, match="ooo"):
        mk.kernel_args(tst, torch.tensor(int(we)),
                       dataclasses.replace(tmodel, tcp_params=more_ranges), ttables, tcfg, rej,
                       mk.PUMP_KERNEL.codel_table("cpu"))


def test_c_struct_matches_the_ctypes_fields():
    """csrc/pump_megakernel.cu's PumpArgs and the wrapper's ctypes
    Structure declare the same fields in the same order."""
    src = (REPO / "shadow_tpu_torch" / "csrc" / "pump_megakernel.cu").read_text()
    start = src.index("struct PumpArgs {") + len("struct PumpArgs {")
    body = re.sub(r"//[^\n]*", "", src[start:src.index("};", start)])
    names = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        decl = decl.replace("void", "").replace("int64_t", "")
        names += [n.strip().lstrip("*").strip() for n in decl.split(",")]
    assert names == [name for name, _ in mk._FIELDS]


def test_layout_constants_match_the_kernel_source():
    """The wrapper's copy of the kernel's compile-time layout equals the
    constexprs in csrc/pump_megakernel.cu, and the default TCP shape (the
    source's PUMP_NR and PUMP_NSEG defaults, which a build at any other
    shape overrides) is tgen's. Every instance the wrapper can pick is
    instantiated in the source: per model a narrow one, built for the
    sockets its model has at its defaults (a narrow row's socket-match
    bitmask is 32 bits) and for pump_k up to MAX_K, and a wide one, which
    takes any pump_k and socket count (in dynamic shared memory its list
    of up to WIDE_LIST_CAP entries a pass, WIDE_FIFO_CAP defer-FIFO
    entries a row and WIDE_MATCH_WORDS socket-match words a warp; FIFO
    entries of FIFO_WORDS words and match words past those in device
    scratch)."""
    src = (REPO / "shadow_tpu_torch" / "csrc" / "pump_megakernel.cu").read_text()

    def constexpr(name):
        return int(re.search(rf"constexpr int (?:\w+ = \d+, )*{name} = (\d+)", src)[1])

    assert (constexpr("ROWS_PER_WARP"), constexpr("STAGE")) == (mk.ROWS_PER_WARP, mk.STAGE)
    assert (constexpr("MAX_K"), constexpr("FIFO_WORDS")) == (mk.MAX_K, mk.FIFO_WORDS)
    assert mk.STAGE > mk.MAX_K
    assert (constexpr("WIDE_LIST_CAP"), constexpr("WIDE_FIFO_CAP"),
            constexpr("WIDE_MATCH_WORDS")) == (mk.WIDE_LIST_CAP, mk.WIDE_FIFO_CAP,
                                               mk.WIDE_MATCH_WORDS)
    assert mk.MAX_K < mk.WIDE_LIST_CAP <= 127  # a list entry's FIFO reference is one byte
    defaults = {n: int(re.search(rf"#ifndef {n}\n#define {n} (\d+)\n#endif", src)[1])
                for n in ("PUMP_NR", "PUMP_NSEG")}
    assert (defaults["PUMP_NR"], defaults["PUMP_NSEG"]) == mk.TCP_SHAPE
    assert "constexpr int NR = PUMP_NR, NSEG = PUMP_NSEG;" in src
    assert mk.TCP_SHAPE == (TGEN_TCP.ooo_ranges, TGEN_TCP.segs_per_flush)
    assert {m: constexpr(f"MODEL_{m.upper()}") for m in mk.MODEL_IDS} == mk.MODEL_IDS
    assert {m: constexpr(f"{m.upper()}_MAX_S") for m in mk.MAX_SOCKETS} == mk.MAX_SOCKETS
    assert TGEN_TCP.num_sockets <= mk.MAX_SOCKETS["tgen"]
    onion_s = OnionModel(num_hosts=4, num_clients=1, num_relays=3).tcp_params.num_sockets
    assert onion_s <= mk.MAX_SOCKETS["onion"] <= 32  # a narrow row's socket bitmask is 32 bits
    assert mk.INSTANCES == ("tgen", "onion", "tgen_wide", "onion_wide")
    launched = set(re.findall(r"pump_megakernel<MODEL_(\w+), (true|false)><<<", src))
    assert launched == {(m.upper(), w) for m in mk.MODEL_IDS for w in ("true", "false")}


def test_auto_engine_resolves_to_the_kernel_on_the_card():
    cfg = EngineConfig(num_hosts=4)
    assert effective_engine(cfg, "cuda") == "megakernel"
    assert effective_engine(cfg, "cpu") == "plain"
    assert effective_engine(dataclasses.replace(cfg, pump_k=4), "cpu") == "pump"
    assert effective_engine(dataclasses.replace(cfg, engine="megakernel"), "cpu") == "megakernel"


EDGE_HOSTS = 37  # not a multiple of the rows a warp owns


@pytest.fixture(scope="module")
def burst():
    """chip_smoke's bench world at EDGE_HOSTS hosts, in its burst, and
    the end of the window its next stage drains."""
    from shadow_tpu_torch import equeue
    from shadow_tpu_torch.engine.round import _next_window_end

    cfg, model, tables, st0 = chip_smoke.bench_world(EDGE_HOSTS, torch.device("cpu"))
    st = run_until(st0, chip_smoke.BURST_NS, model, tables, dataclasses.replace(cfg, engine="plain"))
    we = _next_window_end(st, 10**9, cfg, equeue.next_time(st.queue).amin(), tables)
    return cfg, model, tables, st, int(we)


@pytest.mark.parametrize("capacity", [8, 384, 1100])
def test_edge_states_reach_the_kernel_edges(burst, capacity):
    """chip_smoke's edge-case states (chip_smoke.rebuilt_queue) are valid
    queues that reach what the kernel must get right: rows that start
    full at 8 slots, rows with more slots below the window end than the
    kernel stages at 1,100, a last warp that owns fewer rows than the
    others. Each row keeps its earliest events by (time, tie); added
    events lie below the window end."""
    cfg, model, tables, st, we = burst
    assert EDGE_HOSTS % mk.ROWS_PER_WARP != 0
    extra = chip_smoke.LARGE_QUEUE_EXTRA if capacity > 384 else 0
    e = chip_smoke.rebuilt_queue(st, capacity, we, extra=extra, seed=3)
    q, q0 = e.queue, st.queue
    free = q.time == TIME_MAX
    assert q.time.shape == (EDGE_HOSTS, capacity)
    assert torch.equal(q.count, (~free).sum(dim=1).to(torch.int32))
    assert torch.equal(q.head_time, q.time.amin(dim=1))
    assert bool((q.tie[free] == (1 << 63) - 1).all())
    if capacity == 8:
        assert int((q.count == capacity).sum()) > 0
    if capacity == 1100:
        assert int(((q.time < we).sum(dim=1) > mk.STAGE).sum()) > 0
    for h in range(EDGE_HOSTS):
        old = sorted(zip(q0.time[h].tolist(), q0.tie[h].tolist()))[: int(q0.count[h])]
        new = sorted(zip(q.time[h].tolist(), q.tie[h].tolist()))[: int(q.count[h])]
        assert [k for k in new if k in set(old)] == old[:capacity]
        assert all(t < we for t, tie in new if (t, tie) not in set(old))


@pytest.mark.parametrize("capacity", [8, 1100])
def test_twin_matches_jax_pump_on_rebuilt_queues(mid_run, capacity):
    """The twin, which chip_smoke.py holds the kernel against, equals the
    JAX package's pump_stage (jitted) on the mid-run state rebuilt as the
    smoke's edge states are: 8-slot queues whose rows start full, and
    1,100-slot queues with rows over the kernel's stage."""
    cfg, model, tables, st, we = mid_run
    tcfg, tmodel, ttables = _port_world(cfg, model, tables)
    extra = chip_smoke.LARGE_QUEUE_EXTRA if capacity > 384 else 0
    e = chip_smoke.rebuilt_queue(state_from_numpy(_jax_leaves(st)), capacity, int(we),
                                 extra=extra, seed=3)
    q = e.queue
    if capacity == 8:
        assert int((q.count == capacity).sum()) > 0
    else:
        assert int(((q.time < int(we)).sum(dim=1) > mk.STAGE).sum()) > 0
    want, want_rej = jax.jit(lambda s, w: j_pump_stage(s, w, model, tables, cfg))(
        _jax_state(st, state_to_numpy(e)), we)
    got, got_rej = pump_stage(e, torch.tensor(int(we)), tmodel, ttables, tcfg)
    assert bool(got_rej) == bool(want_rej)
    _assert_leaves_equal(_jax_leaves(want), state_to_numpy(got))


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(mid_run):
    """On a machine with a card: one kernel launch equals one twin stage,
    on the mid-run state and on it rebuilt with 8 queue slots, so that
    rows start full."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cfg, model, tables, st, we = mid_run
    tcfg, tmodel, ttables = _port_world(cfg, model, tables)
    dev = torch.device("cuda")
    tst = state_from_numpy(_jax_leaves(st), device=dev)
    ttables = ttables.to(dev)
    wt = torch.tensor(int(we), device=dev)
    small = chip_smoke.rebuilt_queue(tst, 8, int(we))
    assert int((small.queue.count == 8).sum()) > 0
    for s in (tst, small):
        twin, rej_t = pump_stage(s.clone(), wt, tmodel, ttables, tcfg)
        kern, rej_k = mk.megakernel_stage(s.clone(), wt, tmodel, ttables, tcfg)
        torch.cuda.synchronize()
        assert bool(rej_t) == bool(rej_k)
        _assert_leaves_equal(state_to_numpy(twin), state_to_numpy(kern))


def test_kernel_args_take_an_ensembles_rows():
    """An ensemble's rows view is one launch over R * H rows: the struct
    carries rows_per_replica = H, and the window end, min_used and the
    rejected flags are [R] (a single world keeps its scalars and one
    flag); other shapes are refused before they reach the kernel."""
    from shadow_tpu_torch.engine.ensemble import init_ensemble_state
    from shadow_tpu_torch.engine.state import rows_view

    cpu = torch.device("cpu")
    cfg, model, tables, st = chip_smoke.lossy_world(EDGE_HOSTS, cpu)
    codel = mk.PUMP_KERNEL.codel_table("cpu")
    one, _ = mk.kernel_args(st, torch.tensor(10**7), model, tables, cfg,
                            torch.zeros((1,), dtype=torch.int32), codel)
    assert (one.H, one.rows_per_replica) == (EDGE_HOSTS, EDGE_HOSTS)
    ens = rows_view(init_ensemble_state(cfg, model, 3, 1, device=cpu))
    we = torch.full((3,), 10**7, dtype=torch.int64)
    rej = torch.zeros((3,), dtype=torch.int32)
    args, named = mk.kernel_args(ens, we, model, tables, cfg, rej, codel)
    assert (args.H, args.rows_per_replica) == (3 * EDGE_HOSTS, EDGE_HOSTS)
    assert named["min_used"].shape == (3,) and named["q_time"].shape[0] == 3 * EDGE_HOSTS
    for name, bad_we, bad_rej in (("window_end", torch.tensor(10**7), rej),
                                  ("rejected", we, torch.zeros((1,), dtype=torch.int32))):
        with pytest.raises(ValueError, match=name):
            mk.kernel_args(ens, bad_we, model, tables, cfg, bad_rej, codel)
