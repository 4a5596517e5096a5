"""The pump kernel's wide instances (csrc/pump_megakernel.cu, WIDE), which
take any pump_k and any socket count, as the wrapper sees them on the
CPU: kernel_args picks a model's narrow instance wherever its list and
sockets fit and the wide one past either limit (pump_k past MAX_K on
tests/test_pump.py's tgen world; onion's 65 sockets are in
test_torch_onion.py), with device scratch only for the defer-FIFO
entries past what its shared memory holds; the twin the card holds the
wide instance against equals the JAX package's pump stage at pump_k 40
on that world leaf for leaf, also where rows take 40 events in one
launch and where they hold more slots below the window end than a wide
pass stages, with equal times and ties across the list's end. The
instance
itself runs only on the card (the `cuda`-marked test; chip_smoke.py's
wide_kernel phase at full width). Exact equality."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from test_pump import _world as _tgen_world
from test_torch_megakernel import _jax_state, chip_smoke
from test_torch_ensemble import port_world
from test_torch_slice import _assert_leaves_equal as assert_leaves_equal
from test_torch_slice import _jax_leaves as jax_leaves

from shadow_tpu.engine.pump import pump_stage as j_pump_stage
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch import equeue
from shadow_tpu_torch.engine import megakernel as mk
from shadow_tpu_torch.engine.pump import pump_stage
from shadow_tpu_torch.engine.round import _next_window_end, run_until
from shadow_tpu_torch.engine.state import state_from_numpy, state_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WIDE_K = 40
BOUNDARY_ARRIVALS = chip_smoke.BOUNDARY_ARRIVALS
MID = 10 * NS_PER_MS
DEFER_NS = 45 * NS_PER_MS  # four of the eight rows have no event below the window


def _world(pump_k, engine="pump"):
    jcfg, jm, jt, jst = _tgen_world(8, 0.02, 20_000_000, seed=3)
    jcfg = dataclasses.replace(jcfg, engine=engine, pump_k=pump_k, tracker=True)
    cfg, model, tables = port_world(jcfg, jm, jt)
    return jcfg, jm, jt, jst, cfg, model, tables, state_from_numpy(jax_leaves(jst))


@pytest.mark.parametrize("pump_k,instance", [(1, "tgen"), (mk.MAX_K, "tgen"),
                                             (mk.MAX_K + 1, "tgen_wide"), (WIDE_K, "tgen_wide"),
                                             (mk.WIDE_FIFO_CAP + 16, "tgen_wide")])
def test_kernel_args_pick_the_instance(pump_k, instance):
    """pump_k up to MAX_K runs the narrow instance, past it the wide one,
    whose defer FIFO keeps WIDE_FIFO_CAP entries a row in shared memory:
    device scratch holds the pump_k - WIDE_FIFO_CAP entries past them, and
    exists only then. tgen's 4 sockets a row leave no match words to
    scratch."""
    *_, cfg, model, tables, st = _world(pump_k)
    assert mk.kernel_instance(model, cfg) == instance
    rej = torch.zeros((1,), dtype=torch.int32)
    args, keep = mk.kernel_args(st, torch.tensor(MID), model, tables, cfg, rej,
                                mk.PUMP_KERNEL.codel_table("cpu"))
    wide = instance.endswith("_wide")
    assert (args.pump_k, args.wide) == (pump_k, int(wide))
    past = wide and pump_k > mk.WIDE_FIFO_CAP
    fifo = (st.num_hosts, pump_k - mk.WIDE_FIFO_CAP, mk.FIFO_WORDS) if past else (0,)
    assert tuple(keep["fifo"].shape) == fifo
    assert tuple(keep["match"].shape) == (0,)
    # ctypes reads a null pointer (an empty tensor's) as None
    assert (args.fifo or 0, args.match or 0) == (keep["fifo"].data_ptr(), keep["match"].data_ptr())


@pytest.mark.parametrize("at_ns,arrivals", [
    pytest.param(0, 0, id="0"), pytest.param(DEFER_NS, WIDE_K, id=str(DEFER_NS)),
    pytest.param(DEFER_NS, BOUNDARY_ARRIVALS, id="pass_boundary")])
def test_twin_at_wide_pump_k_matches_jax_pump(at_ns, arrivals):
    """One twin stage at pump_k 40 (what the wide instance is held
    against on the card) equals the JAX package's pump_stage at pump_k 40
    (run eagerly: compiling 40 microsteps takes minutes): in the start's
    burst, and on the DEFER_NS state rebuilt by chip_smoke.deferring_queue
    so that rows take 40 events each (P1 defers) and land 40 defers. The
    pass boundary: rows gain BOUNDARY_ARRIVALS arrivals, more slots below
    the window end than a wide pass stages, in runs of three at one time
    and in pairs at one tie (group 3), so that arrivals 39 and 40 (the
    list's last and the first after it) are equal in both and their
    columns decide; chip_smoke.rebuilt_queue then puts each row's events
    at random columns."""
    jcfg, jm, jt, jst, cfg, model, tables, st = _world(WIDE_K)
    if at_ns:
        mid = run_until(st, at_ns, model, tables, dataclasses.replace(cfg, engine="plain"))
        we = _next_window_end(mid, 10**9, cfg, equeue.next_time(mid.queue).amin(), tables)
        if arrivals == WIDE_K:
            st = chip_smoke.deferring_queue(mid, int(we), WIDE_K)
        else:
            st = chip_smoke.rebuilt_queue(
                chip_smoke.deferring_queue(mid, int(we), arrivals, group=3),
                mid.queue.time.shape[1], int(we))
            below = (st.queue.time < int(we)).sum(dim=1)
            stage = max(mk.STAGE, -(-(min(WIDE_K, mk.WIDE_LIST_CAP) + 2) // 16) * 16)
            assert int((below > stage).sum()) > 0
            # the list's last entry and the first after it: one time, one tie
            q = st.queue
            for h in torch.nonzero(below >= arrivals).flatten().tolist():
                keys = sorted(zip(q.time[h].tolist(), q.tie[h].tolist()))
                assert keys[WIDE_K - 1] == keys[WIDE_K]
        assert int((st.queue.count - mid.queue.count).sum()) >= WIDE_K
    else:
        we = _next_window_end(st, 10**9, cfg, equeue.next_time(st.queue).amin(), tables)
    steps = []
    got, got_rej = pump_stage(st, we, model, tables, cfg, debug_out=steps)
    if at_ns:
        assert all(d["p1"] > 0 for d in steps)  # rows defer in every microstep
    with jax.disable_jit():
        want, want_rej = j_pump_stage(_jax_state(jst, state_to_numpy(st)),
                                      jnp.asarray(int(we), jnp.int64), jm, jt, jcfg)
    assert bool(got_rej) == bool(want_rej)
    assert_leaves_equal(jax_leaves(want), state_to_numpy(got))


@pytest.mark.cuda
def test_wide_instance_matches_twin_on_card():
    """On a machine with a card: one launch of tgen's wide instance at
    pump_k 40 equals one twin stage, mid-run and in the start's burst."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    *_, cfg, model, tables, st = _world(WIDE_K, engine="megakernel")
    tables = tables.to(dev)
    for at in (0, MID):
        s = state_from_numpy(state_to_numpy(run_until(st, at, model, tables.to("cpu"),
                                                      dataclasses.replace(cfg, engine="plain"))
                                            if at else st), device=dev)
        we = _next_window_end(s, 10**9, cfg, equeue.next_time(s.queue).amin(), tables)
        twin, rej_t = pump_stage(s.clone(), we, model, tables, cfg)
        kern, rej_k = mk.megakernel_stage(s.clone(), we, model, tables, cfg)
        torch.cuda.synchronize()
        assert bool(rej_t) == bool(rej_k)
        assert_leaves_equal(state_to_numpy(twin), state_to_numpy(kern))
