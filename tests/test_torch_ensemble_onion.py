"""The ensemble plane on the onion model, whose relays veto the pump
and whose clients take it: the lossy 12-host world of
tests/test_torch_onion_run.py (tests/test_overlay.py's onion world),
R = 2, through the port's megakernel engine (its twin on the CPU),
against the JAX package's ensemble, which runs its pump there. Exact
equality."""

import numpy as np
import pytest
import torch

from test_torch_ensemble import assert_leaves_equal
from test_torch_models import chip_smoke, jax_leaves, worlds

from shadow_tpu.engine.ensemble import init_ensemble_state as j_init_ensemble_state
from shadow_tpu.engine.ensemble import run_ensemble_until as j_run_ensemble_until
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.engine.ensemble import init_ensemble_state, run_ensemble_until
from shadow_tpu_torch.engine.state import state_to_numpy
from shadow_tpu_torch.models.overlay import OnionModel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_onion_ensemble_through_the_kernels_twin_matches_jax():
    model = OnionModel(num_hosts=12, num_clients=5, num_relays=7)
    loss, end = 0.02, 80 * NS_PER_MS
    cfg_kw = dict(queue_capacity=192, outbox_capacity=64, seed=9, tracker=True,
                  engine="megakernel", pump_k=3)
    (jcfg, jm, jtables, _), (cfg, tables, _) = worlds(
        model, loss, chip_smoke.tri_node_gml(loss), [i % 3 for i in range(12)], cfg_kw)
    want = jax_leaves(j_run_ensemble_until(
        j_init_ensemble_state(jcfg, jm, 2, 1), end, jm, jtables, jcfg, rounds_per_chunk=8))
    got = state_to_numpy(run_ensemble_until(
        init_ensemble_state(cfg, model, 2, 1, device="cpu"), end, model, tables, cfg,
        rounds_per_chunk=8))
    assert (want[".model.circuits_built"].sum(axis=1) > 0).all()
    assert want[".packets_dropped"].sum() > 0
    assert not np.array_equal(want[".model.cells_relayed"][0], want[".model.cells_relayed"][1])
    assert_leaves_equal(want, got)
