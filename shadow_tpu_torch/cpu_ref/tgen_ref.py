"""Scalar conformance oracle for the flagship tgen workload (port of
shadow_tpu/cpu_ref/tgen_ref.py): the shared TCP core (cpu_ref/tcp_ref.py)
plus the TgenModel application wrapper — clients cycle request/response
streams over fresh ports against round-robin servers; servers
respond-and-close when the request is fully delivered (models/tgen.py).
This is the main path's workload, so its semantics are independently
bit-checked the same way bulk-tcp's are."""

from __future__ import annotations

import heapq

from shadow_tpu_torch.cpu_ref.tcp_ref import CpuRefTcpBase
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.equeue import PAYLOAD_LANES
from shadow_tpu_torch.events import pack_tie
from shadow_tpu_torch.models.tgen import KIND_STREAM_START, TgenModel
from shadow_tpu_torch.transport.tcp import CLOSED, ESTABLISHED, KIND_TCP_FLUSH, LISTEN


class CpuRefTgen(CpuRefTcpBase):
    """Scalar oracle run of TgenModel under the engine semantics."""

    LOCAL_LANES = 4  # tcp flush + tcp timer + model flush + next-stream

    def __init__(self, cfg: EngineConfig, model: TgenModel, tables, host_node,
                 tx_bytes_per_interval=None, rx_bytes_per_interval=None):
        super().__init__(cfg, model.tcp_params, tables, host_node,
                         tx_bytes_per_interval, rx_bytes_per_interval)
        self.model = model
        self.streams_started = [0] * self.h
        self.streams_done = [0] * self.h
        self.bytes_down = [0] * self.h
        self.resets = [0] * self.h
        self._m_start = False
        self._can = False

        # servers listen on slot 0 (model.init)
        for host in range(self.h):
            if model.num_clients <= host < model.num_clients + model.num_servers:
                s = self.slots[host][0]
                s.st = LISTEN
                s.lport = model.port

    def bootstrap(self):
        m = self.model
        for host in range(m.num_clients):
            tie = pack_tie(KIND_STREAM_START, host, self.seq[host])
            self.seq[host] += 1
            heapq.heappush(
                self.queues[host],
                (m.start_ns, tie, KIND_STREAM_START, (0,) * PAYLOAD_LANES, 0),
            )

    # --- app wrapper ------------------------------------------------------
    def app_pre(self, host, t, kind, data):
        m = self.model
        self._m_start = kind == KIND_STREAM_START and host < m.num_clients
        self._can = False
        if not self._m_start:
            return False, 0
        slots = self.slots[host]
        cslot = next((i for i, s in enumerate(slots) if s.st == CLOSED), None)
        if cslot is None:
            # all slots still in teardown: retry after the pause (app_post)
            return False, 0
        self._can = True
        # fresh local port per stream; round-robin server choice
        lport = 40_000 + self.streams_started[host] % 20_000
        server = m.num_clients + (host + self.streams_started[host]) % m.num_servers
        s = slots[cslot]
        s.app_connect(self.p, lport, server, m.port)
        s.app_write(m.req_bytes)
        self.streams_started[host] += 1
        return True, cslot

    def app_post(self, host, t, kind, data, ctx):
        m = self.model
        slots = self.slots[host]
        is_client = host < m.num_clients
        is_server = m.num_clients <= host < m.num_clients + m.num_servers
        sslot = ctx.sig_slot if ctx.sig_slot >= 0 else 0
        v = slots[sslot]

        # server: request complete -> respond + close (snd_end == 1 <=>
        # nothing written yet on this child)
        m_resp = (
            is_server
            and ctx.sig_slot >= 0
            and v.st == ESTABLISHED
            and v.delivered >= m.req_bytes
            and v.snd_end == 1
        )
        if m_resp:
            v.app_write(m.resp_bytes)
            v.app_close()

        # client: server closed -> close back
        m_eof = ctx.sig_fin and is_client
        if m_eof:
            v.app_close()

        # client: stream fully torn down -> schedule the next
        m_done = ctx.sig_closed and is_client
        if m_done:
            self.streams_done[host] += 1
        if is_client:
            self.bytes_down[host] += sum(s.delivered for s in slots) - ctx.bytes_before
        if ctx.sig_rst:
            self.resets[host] += 1

        if m_resp or m_eof:
            ctx.l_lanes[2] = (t, KIND_TCP_FLUSH, sslot)
        if m_done or (self._m_start and not self._can):
            ctx.l_lanes[3] = (t + m.pause_ns, KIND_STREAM_START, 0)
