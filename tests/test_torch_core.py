"""The port's event queue, netstack and routing equal the JAX package's
on the same numpy inputs: equeue push/peek/pop sequences (including the
dense round-boundary landing under heavy fan-in, with overflow), the
token buckets and CoDel on random inputs, and min-plus routing on the
bench 32-node graph (block=64) and the 1 Gbit switch. Exact equality
throughout: every value is an integer, a bool or an f32 product."""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu import equeue as JQ
from shadow_tpu import netstack as JN
from shadow_tpu.graph import NetworkGraph as JGraph
from shadow_tpu.graph import compute_routing as j_routing
from shadow_tpu.graph.network_graph import ONE_GBIT_SWITCH_GML
from shadow_tpu_torch import equeue as TQ
from shadow_tpu_torch import netstack as TN
from shadow_tpu_torch.graph import NetworkGraph as TGraph
from shadow_tpu_torch.graph import compute_routing as t_routing
from shadow_tpu_torch.simtime import TIME_MAX


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run next to other test processes (pytest-xdist): keep
    torch to one intra-op thread so they do not crowd the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


Q_FIELDS = ("time", "tie", "kind", "data", "aux", "count", "overflow", "head_time")

# the reference's queue operations, each compiled once (op-by-op dispatch
# of the same functions compiles every primitive separately)
J_PUSH_SELF_LANES = jax.jit(JQ.push_self_lanes)
J_POP_MIN = jax.jit(JQ.pop_min)
J_PUSH_MANY_SORTED = jax.jit(JQ.push_many_sorted, static_argnames="deliver_lanes")
J_PUSH_SELF = jax.jit(JQ.push_self)
J_PUSH_MANY = jax.jit(JQ.push_many)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.copy())


def _assert_queue_equal(jq, tq):
    for f in Q_FIELDS:
        np.testing.assert_array_equal(
            getattr(tq, f).numpy(), np.asarray(getattr(jq, f)), err_msg=f
        )


def _events(rng, shape, t_hi=1000, sentinel=0.0):
    time = rng.integers(0, t_hi, shape).astype(np.int64)
    if sentinel:
        time = np.where(rng.random(shape) < sentinel, TIME_MAX, time)
    return dict(
        valid=rng.random(shape) < 0.7,
        time=time,
        tie=rng.integers(0, 1 << 40, shape).astype(np.int64),
        kind=rng.integers(-1, 6, shape).astype(np.int32),
        data=rng.integers(-(2**31), 2**31, shape + (8,)).astype(np.int32),
        aux=rng.integers(0, 1 << 25, shape).astype(np.int32),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_equeue_sequences(seed):
    rng = np.random.default_rng(seed)
    h, cap = 6, 10
    jq, tq = JQ.create(h, cap), TQ.create(h, cap)
    for step in range(24):
        op = step % 4
        if op == 0:
            ev = _events(rng, (h, 3), sentinel=0.1)
            jq = J_PUSH_SELF_LANES(jq, **{k: jnp.asarray(v) for k, v in ev.items()})
            tq = TQ.push_self_lanes(tq, **{k: _t(v) for k, v in ev.items()})
        elif op == 1:
            want = rng.random(h) < 0.8
            jev, jq = J_POP_MIN(jq, jnp.asarray(want))
            tev, tq = TQ.pop_min(tq, _t(want))
            for f in ("valid", "time", "tie", "kind", "data", "aux"):
                np.testing.assert_array_equal(
                    getattr(tev, f).numpy(), np.asarray(getattr(jev, f)), err_msg=f
                )
            np.testing.assert_array_equal(tev.src_host.numpy(), np.asarray(jev.src_host))
        elif op == 2:
            m = 40
            # heavy fan-in: most entries target host 0, beyond the grid width
            dst = np.where(rng.random(m) < 0.6, 0, rng.integers(0, h, m)).astype(np.int32)
            ev = _events(rng, (m,))
            lanes = int(rng.choice([3, cap]))
            jq = J_PUSH_MANY_SORTED(
                jq, jnp.asarray(dst), **{k: jnp.asarray(v) for k, v in ev.items()},
                deliver_lanes=lanes,
            )
            tq = TQ.push_many_sorted(
                tq, _t(dst), **{k: _t(v) for k, v in ev.items()}, deliver_lanes=lanes
            )
        else:
            ev = _events(rng, (h,))
            jq = J_PUSH_SELF(jq, **{k: jnp.asarray(v) for k, v in ev.items()})
            tq = TQ.push_self(tq, **{k: _t(v) for k, v in ev.items()})
        _assert_queue_equal(jq, tq)
    assert int(tq.overflow.sum()) > 0  # the capacity paths were exercised


def test_push_many_full_grid():
    rng = np.random.default_rng(9)
    h, cap, m = 5, 12, 30
    dst = rng.integers(0, h, m).astype(np.int32)
    ev = _events(rng, (m,))
    jq = J_PUSH_MANY(JQ.create(h, cap), jnp.asarray(dst), **{k: jnp.asarray(v) for k, v in ev.items()})
    tq = TQ.push_many(TQ.create(h, cap), _t(dst), **{k: _t(v) for k, v in ev.items()})
    _assert_queue_equal(jq, tq)


def _bucket_inputs(rng, h):
    refill = np.where(rng.random(h) < 0.2, 0, rng.integers(1, 3000, h)).astype(np.int64)
    return dict(
        tokens=rng.integers(-2000, 5000, h).astype(np.int64),
        last=rng.integers(0, 5_000_000, h).astype(np.int64),
        refill=refill,
        now=rng.integers(0, 9_000_000, h).astype(np.int64),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_tb_depart(seed):
    rng = np.random.default_rng(seed)
    h = 400
    b = _bucket_inputs(rng, h)
    size = rng.integers(0, 9000, h).astype(np.int64)
    charge = rng.random(h) < 0.8
    want = JN.tb_depart(*(jnp.asarray(b[k]) for k in ("tokens", "last", "refill", "now")),
                        jnp.asarray(size), jnp.asarray(charge))
    got = TN.tb_depart(*(_t(b[k]) for k in ("tokens", "last", "refill", "now")),
                       _t(size), _t(charge))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1])
def test_tb_depart_lanes(seed):
    rng = np.random.default_rng(seed)
    h, lanes = 400, 5
    b = _bucket_inputs(rng, h)
    sizes = rng.integers(0, 3000, (h, lanes)).astype(np.int64)
    charge = rng.random((h, lanes)) < 0.7
    want = JN.tb_depart_lanes(*(jnp.asarray(b[k]) for k in ("tokens", "last", "refill", "now")),
                              jnp.asarray(sizes), jnp.asarray(charge))
    got = TN.tb_depart_lanes(*(_t(b[k]) for k in ("tokens", "last", "refill", "now")),
                             _t(sizes), _t(charge))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codel_dequeue(seed):
    rng = np.random.default_rng(seed)
    h = 500
    jnet = JN.create(h, 1000, 1000)
    fields = dict(
        codel_first_above=np.where(rng.random(h) < 0.4, -1,
                                   rng.integers(0, 400_000_000, h)).astype(np.int64),
        codel_drop_next=rng.integers(0, 400_000_000, h).astype(np.int64),
        codel_count=rng.integers(0, 1100, h).astype(np.int32),
        codel_dropping=rng.random(h) < 0.5,
        rx_backlog_bytes=rng.integers(0, 4000, h).astype(np.int64),
    )
    jnet = jnet.replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    tnet = dataclasses.replace(TN.create(h, 1000, 1000), **{k: _t(v) for k, v in fields.items()})
    now = rng.integers(0, 500_000_000, h).astype(np.int64)
    sojourn = rng.integers(0, 30_000_000, h).astype(np.int64)
    active = rng.random(h) < 0.8
    jd, jn = JN.codel_dequeue(jnet, jnp.asarray(now), jnp.asarray(sojourn), jnp.asarray(active))
    td, tn = TN.codel_dequeue(tnet, _t(now), _t(sojourn), _t(active))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for f in ("codel_first_above", "codel_drop_next", "codel_count", "codel_dropping"):
        np.testing.assert_array_equal(getattr(tn, f).numpy(), np.asarray(getattr(jn, f)), err_msg=f)
    np.testing.assert_array_equal(
        TN.bw_bits_per_sec_to_refill([0, 7, 100_000_000, 10**10]),
        np.asarray(JN.bw_bits_per_sec_to_refill(jnp.asarray([0, 7, 100_000_000, 10**10]))),
    )


def _bench_gml(seed=7, n_nodes=32):
    rng_py = random.Random(seed)
    lines = ["graph [", "  directed 0"]
    for i in range(n_nodes):
        lines.append(f"  node [ id {i} ]")
        lines.append(f'  edge [ source {i} target {i} latency "2 ms" ]')
    for i in range(n_nodes):
        for j in rng_py.sample(range(n_nodes), 6) + [(i + 1) % n_nodes]:
            if j != i:
                lat = rng_py.randrange(2, 12)
                lines.append(
                    f'  edge [ source {i} target {j} latency "{lat} ms" packet_loss 0.005 ]'
                )
    lines.append("]")
    return "\n".join(lines)


@pytest.mark.parametrize(
    "gml,block", [(_bench_gml(), 64), (_bench_gml(3, 20), 8), (ONE_GBIT_SWITCH_GML, 128)],
    ids=["bench32", "random20", "switch"],
)
def test_compute_routing(gml, block):
    jt = j_routing(JGraph.from_gml(gml), block=block)
    tt = t_routing(TGraph.from_gml(gml), block=block, device="cpu")
    for f in ("lat_ns", "rel", "lookahead_ns"):
        w, g = np.asarray(getattr(jt, f)), getattr(tt, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                      w.view(np.int32) if w.dtype == np.float32 else w)
    assert tt.min_path_latency_ns() == jt.min_path_latency_ns()
    hosts = [i % jt.num_nodes for i in range(40)]
    np.testing.assert_array_equal(
        tt.with_hosts(hosts).host_node.numpy(), np.asarray(jt.with_hosts(hosts).host_node)
    )


def test_engine_config_mirrors_the_reference():
    """One config maps onto both packages: same fields, same defaults,
    same validation."""
    from shadow_tpu.engine.state import EngineConfig as JCfg
    from shadow_tpu_torch.engine.state import EngineConfig as TCfg

    want = [(f.name, f.default) for f in dataclasses.fields(JCfg)]
    assert [(f.name, f.default) for f in dataclasses.fields(TCfg)] == want
    for bad in (dict(engine="warp"), dict(runahead_ns=0), dict(num_hosts=0)):
        kw = dict(num_hosts=4, **bad) if "num_hosts" not in bad else bad
        with pytest.raises(ValueError):
            JCfg(**kw)
        with pytest.raises(ValueError):
            TCfg(**kw)
