"""The port's hybrid scheduler (shadow_tpu_torch/runtime/hybrid.py):
managed guests on the port's host kernel, their packets on the port's
device engine (here on the CPU), against the JAX package's hybrid on the
worlds of tests/test_hybrid.py — TCP, TCP under loss, run twice, shaped
UDP — and against the port's own serial kernel. Guest stdout, strace
files, pcap bytes, the event log (a time-sorted multiset: drain batching
changes append order, never content), the stats and the device pass
count are equal. One device pass of ManagedNetModel with both engine
hooks firing (a loss drop recorded at the source, a CoDel drop at the
destination) is held leaf for leaf against the JAX pass."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from test_torch_hostk import (
    SERIAL_WORLDS,
    W,
    _blast_world,
    _one_torch_thread,  # noqa: F401  (module fixture)
    _tcp_world,
    bins,  # noqa: F401  (module fixture)
    outcome,
    run_serial,
    tables_pair,
)
from test_torch_slice import _jax_leaves

from shadow_tpu import equeue as j_equeue
from shadow_tpu.engine import EngineConfig as JEngineConfig
from shadow_tpu.hostk.kernel import NetKernel as JNetKernel
from shadow_tpu.hostk.kernel import ProcessSpec as JProcessSpec
from shadow_tpu.runtime import hybrid as j_hybrid
from shadow_tpu_torch import equeue
from shadow_tpu_torch.engine.state import EngineConfig, state_to_numpy
from shadow_tpu_torch.events import KIND_PACKET, pack_tie
from shadow_tpu_torch.hostk.kernel import NetKernel, ProcessSpec
from shadow_tpu_torch.models.managed_net import (
    LANE_DST,
    LANE_SEQ,
    LANE_SIZE,
    LANE_SRC,
    REC_CODEL_DROP,
    REC_DELIVER,
    REC_LOSS_DROP,
)
from shadow_tpu_torch.netstack import bw_bits_per_sec_to_refill
from shadow_tpu_torch.runtime import hybrid
from shadow_tpu_torch.simtime import NS_PER_MS, NS_PER_SEC


def _refills(bw_up, bw_down):
    use_net = any(bw_up) or any(bw_down)
    if not use_net:
        return use_net, {}
    return use_net, dict(
        tx_bytes_per_interval=bw_bits_per_sec_to_refill(np.array(bw_up, np.int64)),
        rx_bytes_per_interval=bw_bits_per_sec_to_refill(np.array(bw_down, np.int64)),
    )


def run_hybrid(package, bins, data_dir, world, loss=None):
    """One world of SERIAL_WORLDS through a hybrid scheduler: the JAX
    package's ("ref") or the port's on the CPU ("port"). Returns the
    outcome and the device pass count."""
    w_loss, seed, bw_down, kind, until_s, use_pcap = SERIAL_WORLDS[world]
    loss = w_loss if loss is None else loss
    jt, tt = tables_pair([0, 1], loss)
    bw_up = (0, 0)
    use_net, refills = _refills(bw_up, bw_down)
    if package == "ref":
        kcls, scls, tables, sched_cls = JNetKernel, JProcessSpec, jt, j_hybrid.HybridScheduler
        ecfg = JEngineConfig(num_hosts=2, queue_capacity=256, outbox_capacity=64,
                             runahead_ns=W, seed=seed, use_netstack=use_net)
        extra = {}
    else:
        kcls, scls, tables, sched_cls = NetKernel, ProcessSpec, tt, hybrid.HybridScheduler
        ecfg = EngineConfig(num_hosts=2, queue_capacity=256, outbox_capacity=64,
                            runahead_ns=W, seed=seed, use_netstack=use_net)
        extra = {"device": "cpu"}
    k = kcls(tables, host_names=["server", "client"], host_nodes=[0, 1], seed=seed,
             data_dir=data_dir, window_ns=W, bw_up_bits=list(bw_up),
             bw_down_bits=list(bw_down), pcap=use_pcap)
    runner = sched_cls(k, tables, ecfg, **refills, **extra)
    procs = (_tcp_world(k, bins, scls, 50_000) if kind == "tcp"
             else _blast_world(k, bins, scls))
    try:
        runner.run(until_s * NS_PER_SEC)
    finally:
        k.shutdown()
    return outcome(k, procs, data_dir), runner.device_passes, k


@pytest.mark.parametrize("world", sorted(SERIAL_WORLDS))
def test_hybrid_matches_reference_and_serial(tmp_path, bins, world):  # noqa: F811
    want, want_passes, _ = run_hybrid("ref", bins, tmp_path / "ref", world)
    got, passes, k = run_hybrid("port", bins, tmp_path / "port", world)
    serial = run_serial("port", bins, tmp_path / "serial", world)
    assert passes > 0  # the device engine carried the traffic
    assert passes == want_passes
    if world == "tcp_loss":
        assert sum(h.packets_dropped for h in k.hosts) > 0  # loss drawn on the device
    if world == "udp_shaped":
        assert sum(h.codel_dropped for h in k.hosts) > 0  # AQM drops on the device
    assert got == want
    # the serial kernel writes frames as it emits them; the hybrid learns
    # of a send's frame only with its outcome and writes each host's
    # frames sorted by time (_SortingPcap), as the reference does
    assert _frames_as_multisets(got) == _frames_as_multisets(serial)


def _pcap_frames(data: bytes) -> list:
    """A pcap file's records (16-byte record header + frame), sorted."""
    out, off = [], 24
    while off < len(data):
        n = int.from_bytes(data[off + 8:off + 12], "little")
        out.append(data[off:off + 16 + n])
        off += 16 + n
    return sorted(out)


def _frames_as_multisets(o: dict) -> dict:
    files = {k: (_pcap_frames(v) if k.endswith(".pcap") else v) for k, v in o["files"].items()}
    return {**o, "files": files}


def test_hybrid_run_twice_deterministic(tmp_path, bins):  # noqa: F811
    """Two port hybrid runs at 2% loss: identical, the event log's append
    order included."""
    a, pa, ka = run_hybrid("port", bins, tmp_path / "h1", "tcp", loss=0.02)
    b, pb, kb = run_hybrid("port", bins, tmp_path / "h2", "tcp", loss=0.02)
    assert ka.event_log == kb.event_log
    assert (a, pa) == (b, pb)


# --- one device pass with both hooks --------------------------------------


def _crafted_net(net, replace):
    """Host 1's ingress: a slow relay (100 B/ms), a bucket emptied at
    41 ms, a backlog above one MTU and a sojourn episode begun at 0, so
    the first arrival that waits past CoDel's target is dropped."""
    return replace(
        net,
        rx_tokens=net.rx_tokens * 0,
        rx_last=net.rx_last * 0 + 41 * NS_PER_MS,
        rx_backlog_bytes=net.rx_backlog_bytes * 0 + 5_000,
        codel_first_above=net.codel_first_above * 0,
    )


def _events():
    """Four managed sends host 0 -> 1 (carried loss counters 0..3, one of
    them a counter past 2**31 whose i32 lane is negative) and three
    arrivals at host 1, in window [0, 100 ms)."""
    sends = [(40 * NS_PER_MS + i, 0, 10 + i, c, 1, 1200)
             for i, c in enumerate((0, 1, 2**31 + 7, 3))]
    arr_time = np.array([41, 42, 43], np.int64) * NS_PER_MS
    arr_data = np.zeros((3, equeue.PAYLOAD_LANES), np.int32)
    arr_data[:, LANE_DST], arr_data[:, LANE_SRC] = 1, 0
    arr_data[:, LANE_SIZE], arr_data[:, LANE_SEQ] = 1200, [1, 2, 3]
    arr_tie = np.array([int(pack_tie(KIND_PACKET, 0, s)) for s in (1, 2, 3)], np.int64)
    return sends, (arr_time, arr_data, arr_tie)


def _dummy_kernel():
    return types.SimpleNamespace(window_ns=W, pcap=None, hybrid=False)


def test_one_device_pass_with_both_hooks_matches_reference():
    loss = 0.5
    jt, tt = tables_pair([0, 1], loss)
    _, refills = _refills((0, 0), (0, 800_000))
    jcfg = JEngineConfig(num_hosts=2, queue_capacity=32, outbox_capacity=16, runahead_ns=W,
                         seed=9, use_netstack=True)
    tcfg = EngineConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)})
    jref = j_hybrid.HybridScheduler(_dummy_kernel(), jt, jcfg, record_capacity=4, **refills)
    port = hybrid.HybridScheduler(_dummy_kernel(), tt, tcfg, record_capacity=4,
                                  device="cpu", **refills)
    jref.st = jref.st.replace(net=_crafted_net(jref.st.net, lambda n, **kw: n.replace(**kw)))
    port.plane.st = dataclasses.replace(
        port.plane.st, net=_crafted_net(port.plane.st.net, dataclasses.replace))
    sends, (a_time, a_data, a_tie) = _events()
    n = len(a_time)
    jref.st = jref.st.replace(queue=j_equeue.push_many(
        jref.st.queue, dst=np.ones(n, np.int32), valid=np.ones(n, bool), time=a_time,
        tie=a_tie, kind=np.zeros(n, np.int32), data=a_data,
        aux=np.full(n, 1200, np.int32)))
    port.plane.st = dataclasses.replace(port.plane.st, queue=equeue.push_many(
        port.plane.st.queue, dst=torch.ones(n, dtype=torch.int32),
        valid=torch.ones(n, dtype=torch.bool), time=torch.from_numpy(a_time),
        tie=torch.from_numpy(a_tie), kind=torch.zeros(n, dtype=torch.int32),
        data=torch.from_numpy(a_data), aux=torch.full((n,), 1200, dtype=torch.int32)))
    for s in (jref, port):
        s._upload_sends(sends)
        s._run_pass(100 * NS_PER_MS)
    want_recs = j_hybrid._fetch_records(jref.st, jref._probe)
    got_recs = hybrid._fetch_records(port.st, port._probe)
    assert got_recs == want_recs
    flags = got_recs[3]
    assert REC_LOSS_DROP in flags and REC_CODEL_DROP in flags and REC_DELIVER in flags
    want = _jax_leaves(jref.st)
    got = state_to_numpy(port.st)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(port._probe.numpy(), np.asarray(jax.device_get(jref._probe)))
