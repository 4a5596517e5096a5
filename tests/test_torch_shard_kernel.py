"""The pump kernel on one shard's rows (shadow_tpu_torch/engine/
sharded.py: a shard's row index is not its host id) against its plain
twin, leaf for leaf. It needs a card (the kernel has no CPU mode) and
skips without one; the file imports no JAX, so it runs where the card
is: `python -m pytest --noconftest -m cuda tests/test_torch_shard_kernel.py`.
chip_smoke.py's shard_stage does the same at full width."""

import dataclasses

import pytest
import torch


@pytest.mark.cuda
@pytest.mark.parametrize("shard", [1, 3])
def test_kernel_on_shard_rows_matches_twin_on_card(shard):
    """chip_smoke's bench world at 1,024 hosts, advanced by the plain
    engine into its burst and cut into 4 shards: one kernel launch on
    shard `shard`'s 256 rows, at the world's window end, equals the
    twin's stage, every leaf and the rejected flag."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import chip_smoke as cs

    from shadow_tpu_torch import equeue
    from shadow_tpu_torch.engine import megakernel as mk
    from shadow_tpu_torch.engine.pump import pump_stage
    from shadow_tpu_torch.engine.round import _next_window_end, run_until
    from shadow_tpu_torch.engine.sharded import split_grid
    from shadow_tpu_torch.engine.state import state_to_numpy

    dev = torch.device("cuda")
    cfg, model, tables, st0 = cs.bench_world(1024, dev)
    st = run_until(st0, cs.BURST_NS, model, tables, dataclasses.replace(cfg, engine="plain"))
    we = _next_window_end(st, 10**9, cfg, equeue.next_time(st.queue).amin(), tables)
    cell = split_grid(st, [[dev] * 4])[0][shard]
    assert int(cell.host_id[0]) == shard * 256
    scfg = mk.resolve_stage_cfg(cfg)
    twin, rej_t = pump_stage(cell.clone(), we, model, tables, scfg)
    kern, rej_k = mk.megakernel_stage(cell.clone(), we, model, tables, scfg)
    torch.cuda.synchronize()
    assert bool(rej_t) == bool(rej_k)
    a, b = state_to_numpy(twin), state_to_numpy(kern)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and (a[k] == b[k]).all(), k
