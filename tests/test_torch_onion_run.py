"""Whole onion runs: the port's plain engine and its megakernel engine
(on the CPU, the kernel's twin) against the JAX package's plain engine,
on tests/test_overlay.py's onion world (12 hosts, lossy three-node
graph, no shaping), leaf for leaf. The megakernel engine differs only in
the iteration-structure counters (iters_done, lanes_live), as every
engine-equivalence suite of the JAX package allows. Exact equality."""

import dataclasses

import pytest
import torch

from test_torch_models import assert_leaves_equal, chip_smoke, jax_leaves, worlds

from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.simtime import NS_PER_MS
from shadow_tpu_torch.engine.round import run_until
from shadow_tpu_torch.engine.state import state_to_numpy
from shadow_tpu_torch.models.overlay import OnionModel

END_NS = 200 * NS_PER_MS
LOSS = 0.02
MODEL = OnionModel(num_hosts=12, num_clients=5, num_relays=7)
_RUNS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runs() -> dict:
    """The JAX plain run and the port's plain and megakernel (pump_k 3)
    runs of the one world, computed once."""
    if not _RUNS:
        cfg_kw = dict(queue_capacity=192, outbox_capacity=64, seed=9, tracker=True)
        (jcfg, jm, jtables, jst), (cfg, tables, st) = worlds(
            MODEL, LOSS, chip_smoke.tri_node_gml(LOSS), [i % 3 for i in range(12)], cfg_kw)
        _RUNS["jax"] = jax_leaves(j_run_until(jst, END_NS, jm, jtables, jcfg,
                                              rounds_per_chunk=8))
        for eng, k in (("plain", 0), ("megakernel", 3)):
            c = dataclasses.replace(cfg, engine=eng, pump_k=k)
            _RUNS[eng] = state_to_numpy(run_until(st, END_NS, MODEL, tables, c,
                                                  rounds_per_chunk=8))
    return _RUNS


def test_plain_run_matches_jax():
    runs = _runs()
    want = runs["jax"]
    assert want[".model.streams_done"].sum() > 0  # full streams completed
    assert want[".packets_dropped"].sum() > 0  # loss exercised
    assert want[".model.tcp.retransmits"].sum() > 0  # and recovered
    assert want[".model.circuits_built"].sum() > 0
    assert_leaves_equal(want, runs["plain"])


def test_megakernel_run_matches_jax():
    runs = _runs()
    want, got = dict(runs["jax"]), dict(runs["megakernel"])
    assert got[".iters_done"].sum() <= want[".iters_done"].sum()
    for k in (".iters_done", ".lanes_live"):
        want[k] = got[k] = want[k] * 0
    assert_leaves_equal(want, got)
