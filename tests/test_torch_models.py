"""The port's scripted models without a pump kernel (phold, bulk-tcp, cdn,
gossip) against the JAX package: the bootstrapped state and a whole
plain-engine `run_until` on the reference tests' small worlds equal the
JAX package's leaf for leaf; the registry builds the same models from
the same args and refuses unknown args and names with the same errors;
every model's state crosses to numpy and back unchanged. Exact equality
throughout. The onion model, which runs through the pump kernel, is
held against the JAX package in tests/test_torch_onion.py."""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

from test_torch_slice import _assert_leaves_equal as assert_leaves_equal
from test_torch_slice import _jax_leaves as jax_leaves

from shadow_tpu.engine import EngineConfig as JEngineConfig
from shadow_tpu.engine import init_state as j_init_state
from shadow_tpu.engine.round import bootstrap as j_bootstrap
from shadow_tpu.engine.round import run_until as j_run_until
from shadow_tpu.graph import NetworkGraph as JNetworkGraph
from shadow_tpu.graph import compute_routing as j_compute_routing
from shadow_tpu.models import registry as j_registry
from shadow_tpu.models.bulk import BulkTcpModel as JBulkTcpModel
from shadow_tpu.models.overlay import CdnModel as JCdnModel
from shadow_tpu.models.overlay import GossipModel as JGossipModel
from shadow_tpu.models.overlay import OnionModel as JOnionModel
from shadow_tpu.models.phold import PholdModel as JPholdModel
from shadow_tpu_torch.engine.round import bootstrap, run_until
from shadow_tpu_torch.engine.state import (
    EngineConfig,
    init_state,
    state_from_numpy,
    state_to_numpy,
)
from shadow_tpu_torch.graph import NetworkGraph, compute_routing
from shadow_tpu_torch.models import registry
from shadow_tpu_torch.models.bulk import BulkTcpModel
from shadow_tpu_torch.models.overlay import CdnModel, GossipModel, OnionModel
from shadow_tpu_torch.models.phold import PholdModel
from shadow_tpu_torch.models.tgen import TgenModel
from shadow_tpu_torch.transport.tcp import TcpParams

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the small worlds the smoke runs on the card)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run next to other test processes (pytest-xdist): keep
    torch to one intra-op thread so they do not crowd the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PORT_CLASSES = {
    JPholdModel: PholdModel,
    JBulkTcpModel: BulkTcpModel,
    JOnionModel: OnionModel,
    JCdnModel: CdnModel,
    JGossipModel: GossipModel,
}


def port_model(jmodel):
    """The port's model with every field of a JAX package model."""
    from shadow_tpu.models.tgen import TgenModel as JTgenModel

    cls = TgenModel if isinstance(jmodel, JTgenModel) else _PORT_CLASSES[type(jmodel)]
    kw = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    if kw.get("tcp_params") is not None:
        kw["tcp_params"] = TcpParams(**dataclasses.asdict(kw["tcp_params"]))
    return cls(**kw)


def jax_model(model):
    """The JAX package's model with every field of a port model."""
    jcls = {v: k for k, v in _PORT_CLASSES.items()}[type(model)]
    kw = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}
    if kw.get("tcp_params") is not None:
        from shadow_tpu.transport.tcp import TcpParams as JTcpParams

        kw["tcp_params"] = JTcpParams(**dataclasses.asdict(kw["tcp_params"]))
    return jcls(**kw)


def worlds(model, loss, gml, host_node, cfg_kw, tx=None, rx=None):
    """The same world built by each package from its own code: (JAX cfg,
    tables, bootstrapped state) and (port cfg, tables, bootstrapped
    state), the port's on the CPU."""
    h = model.num_hosts
    jm = jax_model(model)
    jg = JNetworkGraph.from_gml(gml)
    jcfg = JEngineConfig(num_hosts=h, runahead_ns=jg.min_latency_ns(), **cfg_kw)
    jtables = j_compute_routing(jg).with_hosts(host_node)
    jst = j_bootstrap(j_init_state(jcfg, jm.init(), tx, rx), jm, jcfg)
    g = NetworkGraph.from_gml(gml)
    cfg = EngineConfig(num_hosts=h, runahead_ns=g.min_latency_ns(), **cfg_kw)
    tables = compute_routing(g, device="cpu").with_hosts(host_node)
    st = bootstrap(init_state(cfg, model.init("cpu"), tx, rx, device="cpu"), model, cfg)
    return (jcfg, jm, jtables, jst), (cfg, tables, st)


def small_worlds(name):
    """chip_smoke's small world of `name` (tests/test_overlay.py's world
    and three-node graph; a lossy pair world for bulk-tcp)."""
    model, loss = {n: (m, lo) for n, m, lo in chip_smoke.small_model_worlds()}[name]
    h = model.num_hosts
    cfg_kw = dict(queue_capacity=192, outbox_capacity=64, seed=9, tracker=True)
    return worlds(model, loss, chip_smoke.tri_node_gml(loss), [i % 3 for i in range(h)], cfg_kw)


MODELS = ["phold", "bulk-tcp", "cdn", "gossip"]
END_NS = chip_smoke.SMALL_WORLD_END_NS


@pytest.mark.parametrize("name", MODELS)
def test_bootstrapped_state_matches_jax(name):
    (_, _, _, jst), (_, _, st) = small_worlds(name)
    assert_leaves_equal(jax_leaves(jst), state_to_numpy(st))


@pytest.mark.parametrize("name", MODELS)
def test_run_until_matches_jax(name):
    (jcfg, jm, jtables, jst), (cfg, tables, st) = small_worlds(name)
    want = jax_leaves(j_run_until(jst, END_NS, jm, jtables, jcfg, rounds_per_chunk=8))
    got = state_to_numpy(run_until(st, END_NS, port_model(jm), tables, cfg, rounds_per_chunk=8))
    assert want[".events_handled"].sum() > 0
    moved = {
        "phold": ".model.recv_count",
        "bulk-tcp": ".model.conns_closed",
        "cdn": ".model.resp_recv",
        "gossip": ".model.merges",
    }[name]
    assert want[moved].sum() > 0  # the model's own traffic flowed
    if name == "bulk-tcp":
        assert want[".packets_dropped"].sum() > 0  # and the loss path fired
    assert_leaves_equal(want, got)


_ARGS = {
    "phold": {"min_delay": "2 ms", "max_delay": "30 ms", "ball_bytes": 64},
    "bulk-tcp": {"pairs": 3, "total_bytes": 50_000, "start": "5 ms", "mss": 1000,
                 "num_sockets": 2},
    "tgen": {"clients": 4, "resp_bytes": 20_000, "pause": "50 ms"},
    "onion": {"relays": 6, "hops": 2, "cell": 256, "resp_cells": 8, "circuits": 4,
              "tick": "200 us"},
    "cdn": {"mids": 1, "leaves": 3, "objects": 40, "obj_bytes": 5_000, "pause": "20 ms"},
    "gossip": {"view": 4, "fanout": 2, "churn_ppm": 5_000, "interval": "30 ms"},
}


def _fields(model) -> dict:
    out = {f.name: getattr(model, f.name) for f in dataclasses.fields(model)}
    if out.get("tcp_params") is not None:
        out["tcp_params"] = dataclasses.asdict(out["tcp_params"])
    return out


@pytest.mark.parametrize("name", sorted(_ARGS))
def test_registry_builds_the_reference_model(name):
    want = j_registry.build_model(name, 12, _ARGS[name])
    got = registry.build_model(name, 12, _ARGS[name])
    assert type(got).__name__ == type(want).__name__
    assert _fields(got) == _fields(want)
    assert registry.registered_models() == j_registry.registered_models()


@pytest.mark.parametrize("name", sorted(_ARGS))
def test_registry_rejects_unknown_args_like_the_reference(name):
    bad = {**_ARGS[name], "bogus_knob": 1}
    with pytest.raises(ValueError) as want:
        j_registry.build_model(name, 12, bad)
    with pytest.raises(ValueError) as got:
        registry.build_model(name, 12, bad)
    assert str(got.value) == str(want.value)


def test_registry_unknown_model_error_matches_the_reference():
    assert registry._NOT_YET_PORTED == ()
    with pytest.raises(ValueError) as want:
        j_registry.build_model("gosip", 12, {})
    with pytest.raises(ValueError) as got:
        registry.build_model("gosip", 12, {})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", sorted(_ARGS))
def test_state_crosses_to_numpy_and_back(name):
    """state_to_numpy / state_from_numpy round-trip every model's state
    (the JAX package's leaves as numpy become the port's, and back)."""
    model = registry.build_model(name, 12, _ARGS[name])
    cfg = EngineConfig(num_hosts=12, queue_capacity=16, outbox_capacity=8, seed=5)
    st = bootstrap(init_state(cfg, model.init("cpu"), device="cpu"), model, cfg)
    leaves = state_to_numpy(st)
    assert any(k.startswith(".model.") for k in leaves)
    back = state_from_numpy(leaves)
    assert type(back.model) is type(st.model)
    assert_leaves_equal(leaves, state_to_numpy(back))


def test_state_from_numpy_refuses_an_unknown_model_state():
    cfg = EngineConfig(num_hosts=4, queue_capacity=4, outbox_capacity=2)
    leaves = state_to_numpy(init_state(cfg, PholdModel(num_hosts=4).init("cpu"), device="cpu"))
    leaves[".model.extra"] = np.zeros(4, np.int64)
    with pytest.raises(ValueError, match="no model state"):
        state_from_numpy(leaves)
