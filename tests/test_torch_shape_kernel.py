"""The pump kernel's instances at TCP shapes other than tgen's (4, 4)
against their plain twin, leaf for leaf (shadow_tpu_torch/engine/
megakernel.py: a library per shape). It needs a card (the kernel has no
CPU mode) and skips without one; the file imports no JAX, so it runs
where the card is: `python -m pytest --noconftest -m cuda
tests/test_torch_shape_kernel.py`. chip_smoke.py does the same at full
width; tests/test_torch_tcp_shapes.py holds the twin at these shapes
against the JAX package on the CPU."""

import dataclasses

import pytest
import torch

SHAPES = [(8, 8), (2, 2), (1, 1), (16, 16), (1, 16), (16, 1)]
ONION_HOSTS = 256
ONION_AT_NS = 36_000_000  # client rows take P2 and P3 steps in the next stage


def _assert_stage_equal(st, we, model, tables, scfg):
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.pump import pump_stage
    from shadow_tpu_torch.engine.state import state_to_numpy

    steps = []
    twin, rej_t = pump_stage(st.clone(), we, model, tables, scfg, debug_out=steps)
    name = mk.kernel_instance(model, scfg)
    before = mk.PUMP_KERNEL.launches_by_model.get(name, 0)
    kern, rej_k = mk.megakernel_stage(st.clone(), we, model, tables, scfg)
    torch.cuda.synchronize()
    assert mk.PUMP_KERNEL.launches_by_model[name] == before + 1
    assert bool(rej_t) == bool(rej_k)
    a, b = state_to_numpy(twin), state_to_numpy(kern)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and (a[k] == b[k]).all(), k
    return {k: sum(d[k] for d in steps) for k in ("p1", "p2", "p3")}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tgen_instances_at_shape_match_twin_on_card(shape):
    """chip_smoke's lossy tgen world at 1,024 hosts with TGEN_TCP at
    `shape`, advanced by the plain engine into its burst: one kernel
    launch equals the twin's stage at pump_k 8 and 16 (the narrow
    instance) and 40 (the wide one), every leaf and the rejected flag."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke as cs

    from shadow_tpu_torch import equeue
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.round import _next_window_end, run_until

    dev = torch.device("cuda")
    cfg, model, tables, st0 = cs.lossy_world(1024, dev, tcp_shape=shape)
    st = run_until(st0, cs.LOSSY_MID_NS_SHAPED, model, tables,
                   dataclasses.replace(cfg, engine="plain"))
    we = _next_window_end(st, 10**9, cfg, equeue.next_time(st.queue).amin(), tables)
    for k in (8, 16, 40):
        scfg = dataclasses.replace(mk.resolve_stage_cfg(cfg), pump_k=k)
        assert mk.kernel_instance(model, scfg).endswith(f"@{shape[0]}x{shape[1]}")
        taken = _assert_stage_equal(st, we, model, tables, scfg)
        # at one segment a flush a send leaves more to send, which the full
        # handler takes: P3 steps are rare there
        assert taken["p2"] > 0 and (taken["p3"] > 0 or shape[1] == 1), taken


@pytest.mark.cuda
def test_onion_instances_at_2x2_match_twin_on_card():
    """onion_r2s2 (chip_smoke.SHAPE_MODELS) on chip_smoke's onion world at
    ONION_HOSTS hosts, advanced by the plain engine to ONION_AT_NS: the
    narrow (17 sockets) and wide (pump_k 40) instances at (2, 2) equal
    the twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke as cs

    from shadow_tpu_torch import equeue
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.round import _next_window_end, run_until
    from shadow_tpu_torch.models import registry

    dev = torch.device("cuda")
    cs.register_shape_models(registry)
    try:
        cfg, model, tables, st0 = cs.onion_world(ONION_HOSTS, dev, path="onion_r2s2")
    finally:
        for name in cs.SHAPE_MODELS:
            registry._REGISTRY.pop(name, None)
    assert mk.tcp_shape(model) == (2, 2)
    st = run_until(st0, ONION_AT_NS, model, tables,
                   dataclasses.replace(cfg, engine="plain"), rounds_per_chunk=16)
    we = _next_window_end(st, cs.ONION_WINDOW_CAP_NS, cfg, equeue.next_time(st.queue).amin(),
                          tables)
    for k in (8, 40):
        scfg = dataclasses.replace(mk.resolve_stage_cfg(cfg), pump_k=k)
        taken = _assert_stage_equal(st, we, model, tables, scfg)
        assert taken["p2"] > 0 and taken["p3"] > 0, taken
