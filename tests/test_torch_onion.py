"""The onion model through the pump megakernel's module: one stage of an
onion world (relays veto every P2/P3 step, clients pump) equals the JAX
package's megakernel_stage (Pallas interpret mode) leaf for leaf, with
the rejected flag, at three states: a client burst, a state where a
relay row takes a shaped-ingress (P1) defer, and a stage on lossy paths
where the loss draws (3 per event, then the packet lanes) drop packets.
All three share one world shape, model and config, so the JAX kernel
compiles once (the routing tables are traced). On the CPU the port's
megakernel_stage is the kernel's twin (engine/pump.py::pump_stage); the
CUDA kernel's onion instance is held against the twin in the
`cuda`-marked test here and in chip_smoke.py at 10,240 hosts. Exact
equality throughout."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_megakernel import _jax_state
from test_torch_models import assert_leaves_equal, chip_smoke, jax_leaves, worlds

from shadow_tpu.engine.megakernel import megakernel_stage as j_megakernel_stage
from shadow_tpu.graph import NetworkGraph as JNetworkGraph
from shadow_tpu.graph import compute_routing as j_compute_routing
from shadow_tpu_torch import equeue
from shadow_tpu_torch.config.options import NotYetPorted
from shadow_tpu_torch.engine import megakernel as mk
from shadow_tpu_torch.engine.pump import pump_stage
from shadow_tpu_torch.engine.round import _next_window_end, run_until
from shadow_tpu_torch.engine.state import state_from_numpy, state_to_numpy
from shadow_tpu_torch.graph import NetworkGraph, compute_routing
from shadow_tpu_torch.models.overlay import CdnModel, OnionModel
from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill
from shadow_tpu_torch.simtime import NS_PER_MS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


HOSTS = 24
PUMP_K = 2
MODEL = OnionModel(num_hosts=HOSTS, num_clients=HOSTS * 2 // 5,
                   num_relays=HOSTS - HOSTS * 2 // 5, resp_cells=20, pause_ns=50 * NS_PER_MS)
BURST_NS = 32 * NS_PER_MS  # client rows take P2 steps in the next stage
RELAY_DEFER_NS = 24 * NS_PER_MS  # a relay row takes a P1 defer in the next stage
STAGE_LOSS = 0.9  # the lossy stage's path loss between graph nodes


@pytest.fixture(scope="module")
def onion_world():
    """The 20 Mbit onion world (the bench's shaping scaled down so that
    relays defer ingress), lossless, both packages, plus the one jitted
    JAX stage (tables traced) every case shares, and the port's states
    at the burst and the relay-defer time."""
    bw = bw_bits_per_sec_to_refill(20_000_000)
    cfg_kw = dict(queue_capacity=96, outbox_capacity=32, seed=9, use_netstack=True,
                  tracker=True, pump_k=PUMP_K)
    (jcfg, jm, jtables, jst), (cfg, tables, st0) = worlds(
        MODEL, 0.0, chip_smoke.tri_node_gml(0.0), [i % 3 for i in range(HOSTS)], cfg_kw,
        bw, bw)
    stage = jax.jit(lambda s, w, t: j_megakernel_stage(s, w, jm, t, jcfg))
    plain = dataclasses.replace(cfg, engine="plain")
    st_defer = run_until(st0, RELAY_DEFER_NS, MODEL, tables, plain)
    st_burst = run_until(st_defer, BURST_NS, MODEL, tables, plain)
    return dict(jst=jst, jtables=jtables, stage=stage, cfg=cfg, tables=tables,
                states={"burst": st_burst, "relay_defer": st_defer})


def _lossy_tables():
    gml = chip_smoke.tri_node_gml(STAGE_LOSS)
    host_node = [i % 3 for i in range(HOSTS)]
    return (j_compute_routing(JNetworkGraph.from_gml(gml)).with_hosts(host_node),
            compute_routing(NetworkGraph.from_gml(gml), device="cpu").with_hosts(host_node))


@pytest.mark.parametrize("case", ["burst", "relay_defer", "lossy"])
def test_one_stage_matches_jax_megakernel(onion_world, case):
    w = onion_world
    st = w["states"]["relay_defer" if case == "relay_defer" else "burst"]
    jtables, tables = (w["jtables"], w["tables"]) if case != "lossy" else _lossy_tables()
    cfg = w["cfg"]
    we = _next_window_end(st, 10**9, cfg, equeue.next_time(st.queue).amin(), tables)

    # what the stage exercises, from the twin (held equal to JAX below)
    steps = []
    twin, _ = pump_stage(st.clone(), we, MODEL, tables, cfg, debug_out=steps)
    taken = {k: sum(d[k] for d in steps) for k in ("p1", "p2", "p3", "rejected")}
    relay = st.host_id >= MODEL.num_clients
    assert taken["rejected"] > 0 and taken["p2"] + taken["p3"] > 0, taken
    if case == "relay_defer":
        deferred = (twin.net.rx_backlog_bytes != st.net.rx_backlog_bytes) & relay
        assert taken["p1"] > 0 and bool(deferred.any()), taken
    if case == "lossy":
        assert int((twin.packets_dropped - st.packets_dropped).sum()) > 0

    want, want_rej = w["stage"](_jax_state(w["jst"], state_to_numpy(st)),
                                jnp.asarray(int(we), jnp.int64), jtables)
    got, got_rej = mk.megakernel_stage(st.clone(), we, MODEL, tables, cfg)
    assert bool(got_rej) == bool(want_rej)
    assert_leaves_equal(jax_leaves(want), state_to_numpy(got))


def test_kernel_args_carry_onion_rules(onion_world):
    """The wrapper passes onion's instance, socket count and veto scalars;
    past the narrow instance's 32 sockets (16 and 32 circuits per relay:
    33 and 65 sockets) it picks onion's wide instance, whose defer FIFO
    and socket-match words fit its shared memory there, so it gets no
    device scratch; a model without a kernel instance is refused."""
    w = onion_world
    st, cfg, tables = w["states"]["burst"], w["cfg"], w["tables"]
    rej = torch.zeros((1,), dtype=torch.int32)
    codel = mk.PUMP_KERNEL.codel_table("cpu")
    args, _ = mk.kernel_args(st, torch.tensor(BURST_NS), MODEL, tables, cfg, rej, codel)
    assert (args.model, args.S, args.num_clients, args.num_relays, args.resp_span) == (
        mk.MODEL_IDS["onion"], 17, MODEL.num_clients, MODEL.num_relays,
        MODEL.resp_cells * MODEL.cell_bytes)
    assert (args.draws_per_event, args.packet_emits) == (3, 6)
    assert args.streams_started == st.model.streams_started.data_ptr()
    assert args.wide == 0 and mk.kernel_instance(MODEL, cfg) == "onion"
    for circuits, sockets in ((16, 33), (32, 65)):
        big = OnionModel(num_hosts=HOSTS, num_clients=4, num_relays=20,
                         circuits_per_relay=circuits)
        bst = dataclasses.replace(st, model=big.init("cpu"))
        args, keep = mk.kernel_args(bst, torch.tensor(BURST_NS), big, tables, cfg, rej, codel)
        assert (args.model, args.S, args.wide) == (mk.MODEL_IDS["onion"], sockets, 1)
        assert mk.kernel_instance(big, cfg) == "onion_wide"
        # pump_k 8 and 65 sockets: the FIFO and the match words fit shared memory
        assert cfg.pump_k <= mk.WIDE_FIFO_CAP and 8 * sockets <= 32 * mk.WIDE_MATCH_WORDS
        assert tuple(keep["fifo"].shape) == tuple(keep["match"].shape) == (0,)
        assert (args.fifo or 0) == keep["fifo"].data_ptr() == 0  # ctypes: None for null
    cdn = CdnModel(num_hosts=HOSTS)
    with pytest.raises(NotYetPorted, match="CdnModel"):
        mk.kernel_args(st, torch.tensor(BURST_NS), cdn, tables, cfg, rej, codel)


@pytest.mark.cuda
def test_onion_kernel_matches_twin_on_card(onion_world):
    """On a machine with a card: one launch of the kernel's onion
    instance equals one twin stage at the burst, the relay-defer state
    and on lossy paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    w = onion_world
    dev = torch.device("cuda")
    cfg = w["cfg"]
    for case in ("burst", "relay_defer", "lossy"):
        st = w["states"]["relay_defer" if case == "relay_defer" else "burst"]
        tables = w["tables"] if case != "lossy" else _lossy_tables()[1]
        st, tables = state_from_numpy(state_to_numpy(st), device=dev), tables.to(dev)
        we = _next_window_end(st, 10**9, cfg, equeue.next_time(st.queue).amin(), tables)
        twin, rej_t = pump_stage(st.clone(), we, MODEL, tables, cfg)
        kern, rej_k = mk.megakernel_stage(st.clone(), we, MODEL, tables, cfg)
        torch.cuda.synchronize()
        assert bool(rej_t) == bool(rej_k)
        assert_leaves_equal(state_to_numpy(twin), state_to_numpy(kern))
