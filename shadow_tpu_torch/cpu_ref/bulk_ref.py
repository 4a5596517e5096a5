"""Scalar conformance oracle for the bulk-TCP workload (port of
shadow_tpu/cpu_ref/bulk_ref.py): the shared TCP core (cpu_ref/tcp_ref.py) plus the BulkTcpModel application wrapper —
client connects once, queues all bytes, half-closes; server echo-closes
on EOF (models/bulk.py). A conforming device engine must match this
bit-for-bit (reference analogue: src/test/determinism/CMakeLists.txt)."""

from __future__ import annotations

import heapq

from shadow_tpu_torch.cpu_ref.tcp_ref import CpuRefTcpBase, Slot  # noqa: F401 (Slot re-export)
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.equeue import PAYLOAD_LANES
from shadow_tpu_torch.events import pack_tie
from shadow_tpu_torch.models.bulk import KIND_CONNECT, BulkTcpModel
from shadow_tpu_torch.transport.tcp import KIND_TCP_FLUSH, LISTEN


class CpuRefBulk(CpuRefTcpBase):
    """Scalar oracle run of BulkTcpModel under the engine semantics."""

    LOCAL_LANES = 3  # tcp flush + tcp timer + server echo-close flush

    def __init__(self, cfg: EngineConfig, model: BulkTcpModel, tables, host_node,
                 tx_bytes_per_interval=None, rx_bytes_per_interval=None):
        super().__init__(cfg, model.tcp_params, tables, host_node,
                         tx_bytes_per_interval, rx_bytes_per_interval)
        self.model = model
        self.conns_established = [0] * self.h
        self.conns_closed = [0] * self.h
        self.resets = [0] * self.h

        # servers listen on slot 0 (model.init)
        for host in range(self.h):
            if model.num_pairs <= host < 2 * model.num_pairs:
                s = self.slots[host][0]
                s.st = LISTEN
                s.lport = model.port

    def bootstrap(self):
        m = self.model
        for host in range(m.num_pairs):
            tie = pack_tie(KIND_CONNECT, host, self.seq[host])
            self.seq[host] += 1
            heapq.heappush(
                self.queues[host],
                (m.start_ns, tie, KIND_CONNECT, (0,) * PAYLOAD_LANES, 0),
            )

    # --- app wrapper ------------------------------------------------------
    def app_pre(self, host, t, kind, data):
        m = self.model
        if kind != KIND_CONNECT or host >= m.num_pairs:
            return False, 0
        s0 = self.slots[host][0]
        s0.app_connect(self.p, m.client_port, host + m.num_pairs, m.port)
        s0.app_write(m.total_bytes)
        s0.app_close()
        return True, 0

    def app_post(self, host, t, kind, data, ctx):
        m = self.model
        is_server = m.num_pairs <= host < 2 * m.num_pairs
        # server echo-close on EOF: close, then force an output pass via a
        # same-time flush event so the FIN actually goes out
        if ctx.sig_fin and is_server:
            eof_i = ctx.out_i if ctx.out_mask else 0
            self.slots[host][eof_i].app_close()
            ctx.l_lanes[2] = (t, KIND_TCP_FLUSH, eof_i)
        if ctx.sig_est:
            self.conns_established[host] += 1
        if ctx.sig_closed:
            self.conns_closed[host] += 1
        if ctx.sig_rst:
            self.resets[host] += 1
