"""The ensemble plane on tests/test_pump.py's tgen world (8 hosts, lossy
links, 20 Mbit hosts, seed 3), R = 2 and seed stride 3 as in
tests/test_ensemble.py: the port's batch against the JAX package's
ensemble leaf for leaf, with the plain engine and with the pump engine
at pump_k 3, and each replica against the port's single run with its
derived seed; on a machine with a card, one kernel launch over an
ensemble's rows against the twin. Exact equality throughout."""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_ensemble import (
    BW,
    _run,
    _tgen,
    assert_leaves_equal,
    port_world,
)

from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.engine import megakernel as mk
from shadow_tpu_torch.engine.ensemble import (
    init_ensemble_state,
    replica_slice,
    run_ensemble_until,
)
from shadow_tpu_torch.engine.pump import pump_stage
from shadow_tpu_torch.engine.round import _next_window_end
from shadow_tpu_torch.engine.state import rows_view, state_to_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["tgen-plain", "tgen-pump"])
def test_ensemble_matches_jax(name):
    run = _run(name)
    assert run["jax"][".model.streams_done"].sum() > 0
    assert run["jax"][".packets_dropped"].sum() > 0
    assert_leaves_equal(run["jax"], state_to_numpy(run["port"]))


@pytest.mark.parametrize("name", ["tgen-plain", "tgen-pump"])
def test_replicas_match_single_runs(name):
    run = _run(name)
    singles = run["singles"]
    for r, single in enumerate(singles):
        assert_leaves_equal(single, state_to_numpy(replica_slice(run["port"], r)))
    a, b = singles
    assert not np.array_equal(a[".packets_dropped"], b[".packets_dropped"])


@pytest.mark.cuda
def test_kernel_matches_twin_on_an_ensemble_stage_on_card():
    """On a machine with a card: one kernel launch over an ensemble's
    rows (R = 3 replicas of 13 hosts, so warps straddle replicas) equals
    the twin's stage, rejected flags per replica included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    dev = torch.device("cuda")
    cfg, model, tables = port_world(*_tgen(13, "megakernel", 3))
    tables = tables.to(dev)
    ens = init_ensemble_state(cfg, model, 3, 2, BW, BW, device=dev)
    plain = dataclasses.replace(cfg, engine="plain")
    ens = rows_view(run_ensemble_until(ens, 12 * NS_PER_MS, model, tables, plain))
    start = ens.queue.head_time.reshape(3, -1).amin(dim=1)
    we = _next_window_end(ens, 10**9, cfg, start, tables)
    twin, rej_t = pump_stage(ens.clone(), we, model, tables, cfg)
    kern, rej_k = mk.megakernel_stage(ens.clone(), we, model, tables, cfg)
    torch.cuda.synchronize()
    assert torch.equal(rej_t, rej_k)
    assert_leaves_equal(state_to_numpy(twin), state_to_numpy(kern))
