"""tgen-style traffic generator: repeated request/response TCP streams
(port of shadow_tpu/models/tgen.py).

  hosts [0, C)        clients — connect (fresh local port) -> send
                      `req_bytes` -> read `resp_bytes` -> server closes
                      -> client closes back -> CLOSED -> pause -> next
                      stream (server chosen round-robin)
  hosts [C, C+S)      servers — listen; when a child connection has the
                      full request, write the response and close

The model consumes no RNG draws; all variability comes from the network.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.engine.state import EngineConfig, LocalEmits, PacketEmits
from shadow_tpu_torch.equeue import PAYLOAD_LANES
from shadow_tpu_torch.events import KIND_PACKET
from shadow_tpu_torch.simtime import NS_PER_MS, NS_PER_SEC
from shadow_tpu_torch.transport import tcp
from shadow_tpu_torch.transport.tcp import (
    KIND_TCP_FLUSH,
    KIND_TCP_TIMER,
    TCP_KIND_USER_BASE,
    TcpParams,
    TcpState,
)

KIND_STREAM_START = TCP_KIND_USER_BASE

TGEN_TCP = TcpParams(num_sockets=4, timewait_ns=1 * NS_PER_SEC)


@dataclasses.dataclass
class TgenState:
    tcp: TcpState
    streams_started: torch.Tensor  # [H] i64 (client)
    streams_done: torch.Tensor  # [H] i64 (client)
    bytes_down: torch.Tensor  # [H] i64 (client)
    resets: torch.Tensor  # [H] i64


@dataclasses.dataclass(frozen=True)
class TgenModel:
    num_hosts: int
    num_clients: int
    num_servers: int
    req_bytes: int = 64
    resp_bytes: int = 100_000
    pause_ns: int = 500 * NS_PER_MS
    port: int = 80
    start_ns: int = 1 * NS_PER_MS
    tcp_params: TcpParams = TGEN_TCP

    DRAWS_PER_EVENT = 0
    BOOTSTRAP_DRAWS = 0
    TCP_KIND_RANGE = (KIND_TCP_TIMER, TCP_KIND_USER_BASE)

    @property
    def LOCAL_EMITS(self):  # noqa: N802
        return self.tcp_params.local_lanes + 2

    @property
    def PACKET_EMITS(self):  # noqa: N802
        return self.tcp_params.packet_lanes

    @property
    def WIRE_HEADER_BYTES(self):  # noqa: N802
        return self.tcp_params.header_bytes

    def __post_init__(self):
        if self.num_clients + self.num_servers > self.num_hosts:
            raise ValueError("need num_hosts >= num_clients + num_servers")

    def _roles(self, host_id):
        is_client = host_id < self.num_clients
        is_server = (host_id >= self.num_clients) & (
            host_id < self.num_clients + self.num_servers
        )
        return is_client, is_server

    @property
    def pump_spec(self):
        """The pump contract (engine/pump.py). block: the request-complete
        -> respond trigger must reach the full handler. apply: the client
        download byte counter. The CUDA kernel carries the same two rules
        with num_clients, num_servers and req_bytes as arguments."""
        from shadow_tpu_torch.engine.pump import TcpPumpSpec

        req = self.req_bytes
        nc, ns = self.num_clients, self.num_servers

        def block(ms, host_id, v_st, v_snd_end, delivered_new, delta):
            is_server = (host_id >= nc) & (host_id < nc + ns)
            return (
                is_server
                & (v_st == tcp.ESTABLISHED)
                & (delivered_new >= req)
                & (v_snd_end == 1)
            )

        def apply(ms, take, host_id, delta):
            is_client = host_id < nc
            return dataclasses.replace(
                ms, bytes_down=ms.bytes_down + torch.where(is_client & take, delta, 0)
            )

        return TcpPumpSpec(
            params=self.tcp_params,
            get_tcp=lambda ms: ms.tcp,
            set_tcp=lambda ms, ts: dataclasses.replace(ms, tcp=ts),
            block=block,
            apply=apply,
        )

    def init(self, device="cuda") -> TgenState:
        """The model's initial state on `device` (the card unless asked
        for the CPU): servers listen on slot 0."""
        device = resolve_device(device)
        h = self.num_hosts
        ts = tcp.create(h, self.tcp_params, device)
        host_id = torch.arange(h, dtype=torch.int32, device=device)
        _, is_server = self._roles(host_id)
        ts = tcp.listen(
            ts,
            is_server,
            torch.zeros((h,), dtype=torch.int32, device=device),
            torch.full((h,), self.port, dtype=torch.int32, device=device),
        )
        z = torch.zeros((h,), dtype=torch.int64, device=device)
        return TgenState(
            tcp=ts, streams_started=z, streams_done=z.clone(),
            bytes_down=z.clone(), resets=z.clone(),
        )

    def bootstrap(self, draw, host_id) -> LocalEmits:
        h = host_id.shape[0]
        dev = host_id.device
        is_client, _ = self._roles(host_id)
        return LocalEmits(
            valid=is_client[:, None],
            time=torch.full((h, 1), self.start_ns, dtype=torch.int64, device=dev),
            kind=torch.full((h, 1), KIND_STREAM_START, dtype=torch.int32, device=dev),
            data=torch.zeros((h, 1, PAYLOAD_LANES), dtype=torch.int32, device=dev),
        )

    def handle(self, state: TgenState, ev, draw, cfg: EngineConfig, host_id):
        h = host_id.shape[0]
        dev = host_id.device
        p = self.tcp_params
        ts = state.tcp
        is_client, is_server = self._roles(host_id)

        m_start = ev.valid & (ev.kind == KIND_STREAM_START) & is_client
        free = ts.st == tcp.CLOSED
        cslot = torch.argmax(free.to(torch.int32), dim=1).to(torch.int32)
        can = m_start & free.any(dim=1)
        lport = (40_000 + (state.streams_started % 20_000)).to(torch.int32)
        server = (
            self.num_clients
            + (host_id.to(torch.int64) + state.streams_started) % self.num_servers
        ).to(torch.int32)
        app = tcp.AppOpen(
            mask=can,
            slot=cslot,
            lport=lport,
            rhost=server,
            rport=torch.full((h,), self.port, dtype=torch.int32, device=dev),
            write_bytes=torch.full((h,), self.req_bytes, dtype=torch.int64, device=dev),
            close=torch.zeros((h,), dtype=torch.bool, device=dev),
        )
        state = dataclasses.replace(
            state, streams_started=state.streams_started + can.to(torch.int64)
        )

        is_tcp_packet = ev.valid & (ev.kind == KIND_PACKET)
        slot, touched, v, emits, sig, delivered_open = tcp.tcp_handle(
            ts, ev, host_id, p, is_tcp_packet, app=app
        )

        m_resp = (
            is_server
            & (sig.slot >= 0)
            & (v.st == tcp.ESTABLISHED)
            & (v.delivered >= self.req_bytes)
            & (v.snd_end == 1)
        )
        v = tcp.view_write(v, m_resp, self.resp_bytes)
        v = tcp.view_close(v, m_resp)
        m_eof = sig.fin_seen & is_client
        v = tcp.view_close(v, m_eof)
        need_flush = m_resp | m_eof

        ts = tcp.commit_slot(ts, slot, touched, v)

        m_done = sig.closed & is_client
        state = dataclasses.replace(
            state,
            streams_done=state.streams_done + m_done.to(torch.int64),
            bytes_down=state.bytes_down
            + torch.where(is_client & touched, v.delivered - delivered_open, 0),
            resets=state.resets + sig.reset.to(torch.int64),
            tcp=ts,
        )

        zero_data = torch.zeros((h, 1, PAYLOAD_LANES), dtype=torch.int32, device=dev)
        flush_data = zero_data.clone()
        flush_data[:, 0, 0] = slot
        lemits = LocalEmits(
            valid=torch.cat(
                [emits.l_valid, need_flush[:, None], (m_done | (m_start & ~can))[:, None]],
                dim=1,
            ),
            time=torch.cat(
                [emits.l_time, ev.time[:, None], (ev.time + self.pause_ns)[:, None]],
                dim=1,
            ),
            kind=torch.cat(
                [
                    emits.l_kind,
                    torch.full((h, 1), KIND_TCP_FLUSH, dtype=torch.int32, device=dev),
                    torch.full((h, 1), KIND_STREAM_START, dtype=torch.int32, device=dev),
                ],
                dim=1,
            ),
            data=torch.cat([emits.l_data, flush_data, zero_data], dim=1),
        )
        pemits = PacketEmits(
            valid=emits.p_valid, dst=emits.p_dst, data=emits.p_data, size=emits.p_size
        )
        return state, lemits, pemits
