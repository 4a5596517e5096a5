"""CPU reference simulator (port of shadow_tpu/cpu_ref/sim.py): a
plain-Python heapq implementation of the exact engine semantics, used as
the conformance oracle for the device engine (the role the reference's
native schedulers play for the --scheduler=tpu backend).

Every random draw calls the same threefry functions as the device engine
(elementwise, on CPU tensors, with the reference's u32 draw counters),
and the netstack (token-bucket relays + CoDel) uses the same integer
arithmetic, so a conforming engine must match bit-for-bit: identical
event traces under the total order, identical final counters, identical
leftover queue contents. The oracle reads the routing tables to numpy,
wherever they live.
"""

from __future__ import annotations

import heapq

import numpy as np
import torch

from shadow_tpu_torch import rng
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.equeue import PAYLOAD_LANES
from shadow_tpu_torch.events import KIND_PACKET, pack_tie, tie_src_host
from shadow_tpu_torch.models.phold import KIND_SEND, PholdModel
from shadow_tpu_torch.cpu_ref.netstack_ref import CoDelRef, TokenBucketRef
from shadow_tpu_torch.netstack import AUX_SHAPED_BIT, AUX_SIZE_MASK
from shadow_tpu_torch.simtime import TIME_MAX


def host_array(x) -> np.ndarray:
    """A table (tensor on any device, or array) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def draw_counter(counter: int) -> torch.Tensor:
    """One draw counter as the [1] tensor rng takes: the reference's u32
    counter, carried in int64."""
    return torch.tensor([counter & 0xFFFFFFFF], dtype=torch.int64)


class CpuRefPhold:
    def __init__(self, cfg: EngineConfig, model: PholdModel, tables, host_node,
                 tx_bytes_per_interval=None, rx_bytes_per_interval=None):
        self.cfg = cfg
        self.model = model
        self.h = cfg.num_hosts
        self.keys = rng.host_keys(cfg.seed, self.h)
        self.lat = host_array(tables.lat_ns)
        self.rel = host_array(tables.rel)
        self.node = [int(x) for x in host_node]
        self.queues = [[] for _ in range(self.h)]  # heaps of (time, tie, kind, data, aux)
        self.seq = [0] * self.h
        self.ctr = [0] * self.h
        self.recv = [0] * self.h
        self.send = [0] * self.h
        self.packets_sent = [0] * self.h
        self.packets_dropped = [0] * self.h
        self.trace = []  # (time, tie, kind, data, host) in processing order

        def _bw(v, i):
            if v is None:
                return 0
            return int(v if np.ndim(v) == 0 else v[i])

        self.tx_tb = [TokenBucketRef(_bw(tx_bytes_per_interval, i)) for i in range(self.h)]
        self.rx_tb = [TokenBucketRef(_bw(rx_bytes_per_interval, i)) for i in range(self.h)]
        self.codel = [CoDelRef() for _ in range(self.h)]
        self.rx_backlog = [0] * self.h
        self.codel_dropped = [0] * self.h
        self.bytes_sent = [0] * self.h
        self.bytes_recv = [0] * self.h

    # --- identical draw primitives (threefry, counter-based) ---
    def _u_int(self, host, counter, lo, hi) -> int:
        return int(
            rng.uniform_int(
                self.keys[host : host + 1], draw_counter(counter), lo, hi
            )[0]
        )

    def _u_f32(self, host, counter) -> float:
        return float(
            rng.uniform_f32(self.keys[host : host + 1], draw_counter(counter))[0]
        )

    def _peer(self, host, counter) -> int:
        if self.h == 1:
            return 0
        p = self._u_int(host, counter, 0, self.h - 1)
        return p + (1 if p >= host else 0)

    def bootstrap(self):
        m = self.model
        for host in range(self.h):
            dst = self._peer(host, 0)
            offset = self._u_int(host, 1, m.min_delay_ns, m.max_delay_ns)
            tie = pack_tie(KIND_SEND, host, self.seq[host])
            self.seq[host] += 1
            heapq.heappush(self.queues[host], (offset, tie, KIND_SEND, (dst,) + (0,) * (PAYLOAD_LANES - 1), 0))
            self.ctr[host] = m.BOOTSTRAP_DRAWS

    def _ingress(self, host, t, tie, kind, data, aux) -> bool:
        """Ingress relay + CoDel (mirrors handle_one_iteration's ingress
        phase). Returns True if the event should be handled by the model
        now; deferred/dropped events return False."""
        if not self.cfg.use_netstack or kind != KIND_PACKET:
            return True
        size = aux & AUX_SIZE_MASK
        shaped = bool(aux & AUX_SHAPED_BIT)
        if shaped:
            self.rx_backlog[host] -= size
            self.bytes_recv[host] += size
            return True
        src = int(tie_src_host(tie))
        exempt = (
            src == host
            or t < self.cfg.bootstrap_end_ns
            or self.rx_tb[host].refill <= 0
        )
        if exempt:
            self.bytes_recv[host] += size
            return True
        tb = self.rx_tb[host]
        tok0, last0 = tb.tokens, tb.last
        ready = tb.depart(t, size)
        sojourn = ready - t
        if self.codel[host].dequeue(ready, sojourn, self.rx_backlog[host]):
            tb.tokens, tb.last = tok0, last0  # drop: tokens not consumed
            self.codel_dropped[host] += 1
            return False
        if ready > t:
            self.rx_backlog[host] += size
            heapq.heappush(
                self.queues[host], (ready, tie, kind, data, size | AUX_SHAPED_BIT)
            )
            return False
        self.bytes_recv[host] += size
        return True

    def _send_packet(self, host, t, dst, data, size, counter, window_end, outbox):
        """Egress relay + routing + loss (mirrors the egress phase)."""
        lat = int(self.lat[self.node[host], self.node[dst]])
        rel = float(self.rel[self.node[host], self.node[dst]])
        loss_u = self._u_f32(host, counter)
        if lat >= TIME_MAX:
            return
        dep = t
        if self.cfg.use_netstack:
            exempt = dst == host or t < self.cfg.bootstrap_end_ns
            if not exempt:
                dep = self.tx_tb[host].depart(t, size)
        if loss_u < rel:
            deliver = max(dep + lat, window_end)
            ptie = pack_tie(KIND_PACKET, host, self.seq[host])
            self.seq[host] += 1
            outbox.append((dst, deliver, ptie, data, size & AUX_SIZE_MASK))
            self.packets_sent[host] += 1
            if self.cfg.use_netstack:
                self.bytes_sent[host] += size
        else:
            self.packets_dropped[host] += 1

    def _handle(self, host, t, tie, kind, data, aux, window_end, outbox):
        m = self.model
        self.trace.append((t, tie, kind, data, host))
        if not self._ingress(host, t, tie, kind, data, aux):
            return
        base = self.ctr[host]
        if kind == KIND_PACKET:
            self.recv[host] += 1
            dst = self._peer(host, base + 0)
            delay = self._u_int(host, base + 1, m.min_delay_ns, m.max_delay_ns)
            ltie = pack_tie(KIND_SEND, host, self.seq[host])
            self.seq[host] += 1
            heapq.heappush(self.queues[host], (t + delay, ltie, KIND_SEND, (dst,) + (0,) * (PAYLOAD_LANES - 1), 0))
        elif kind == KIND_SEND:
            self.send[host] += 1
            self._send_packet(
                host, t, data[0], (0,) * PAYLOAD_LANES, m.ball_bytes,
                base + m.DRAWS_PER_EVENT + 0, window_end, outbox,
            )
        else:
            raise AssertionError(f"unknown kind {kind}")
        self.ctr[host] = base + m.DRAWS_PER_EVENT + m.PACKET_EMITS

    def next_time(self) -> int:
        nts = [q[0][0] for q in self.queues if q]
        return min(nts) if nts else TIME_MAX

    def run_until(self, end_time: int):
        while True:
            start = self.next_time()
            if start >= end_time:
                break
            window_end = min(start + self.cfg.runahead_ns, end_time)
            outbox = []
            for host in range(self.h):
                q = self.queues[host]
                while q and q[0][0] < window_end:
                    t, tie, kind, data, aux = heapq.heappop(q)
                    self._handle(host, t, tie, kind, data, aux, window_end, outbox)
            for dst, deliver, ptie, data, size in outbox:
                heapq.heappush(self.queues[dst], (deliver, ptie, KIND_PACKET, data, size))

    def queue_contents(self, host) -> list:
        return sorted((t, tie, kind, data) for t, tie, kind, data, _aux in self.queues[host])
