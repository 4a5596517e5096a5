"""The module that holds the pump megakernel (shadow_tpu_torch/engine/
megakernel.py). On the CPU, megakernel_stage runs the kernel's plain twin
(engine/pump.py::pump_stage); one stage must equal the JAX package's
megakernel_stage (Pallas interpret mode) leaf for leaf, including the
rejected flag, on a mid-run state where P1, P2 and P3 all fire. The
mid-run state comes from the JAX megakernel engine on the world and
config of tests/test_torch_slice.py, so the two files share that run's
compile. The CUDA kernel itself runs only on the card (the `cuda`-marked
test; chip_smoke.py holds it against the twin at full width). Exact
equality throughout."""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pump import _world

from shadow_tpu.engine.megakernel import megakernel_stage as j_megakernel_stage
from shadow_tpu.engine.round import _next_window_end as j_next_window_end
from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.engine import megakernel as mk
from shadow_tpu_torch.engine.pump import pump_stage
from shadow_tpu_torch.engine.round import effective_engine
from shadow_tpu_torch.engine.state import EngineConfig, state_from_numpy, state_to_numpy
from shadow_tpu_torch.graph.routing import RoutingTables
from shadow_tpu_torch.models.tgen import TgenModel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run next to other test processes (pytest-xdist): keep
    torch to one intra-op thread so they do not crowd the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = pathlib.Path(__file__).resolve().parent.parent
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


def test_auto_engine_resolves_to_the_kernel_on_the_card():
    cfg = EngineConfig(num_hosts=4)
    assert effective_engine(cfg, "cuda") == "megakernel"
    assert effective_engine(cfg, "cpu") == "plain"
    assert effective_engine(dataclasses.replace(cfg, pump_k=4), "cpu") == "pump"
    assert effective_engine(dataclasses.replace(cfg, engine="megakernel"), "cpu") == "megakernel"


@pytest.mark.cuda
def test_kernel_matches_twin_on_card(mid_run):
    """On a machine with a card: one kernel launch equals one twin stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    cfg, model, tables, st, we = mid_run
    tcfg, tmodel, ttables = _port_world(cfg, model, tables)
    dev = torch.device("cuda")
    tst = state_from_numpy(_jax_leaves(st), device=dev)
    ttables = ttables.to(dev)
    wt = torch.tensor(int(we), device=dev)
    twin, rej_t = pump_stage(tst.clone(), wt, tmodel, ttables, tcfg)
    kern, rej_k = mk.megakernel_stage(tst.clone(), wt, tmodel, ttables, tcfg)
    torch.cuda.synchronize()
    assert bool(rej_t) == bool(rej_k)
    _assert_leaves_equal(state_to_numpy(twin), state_to_numpy(kern))
