"""Bulk TCP transfer: the iperf-like workload (port of
shadow_tpu/models/bulk.py).

Hosts [0, P) are clients, hosts [P, 2P) are servers; client i connects
to server i+P at `start_ns`, writes `total_bytes`, and closes; servers
listen, consume instantly, and close back on EOF. Handshake, Reno,
retransmissions and FIN teardown all run in transport/tcp.py.

Goodput observable: server-side `tcp.delivered` byte counters.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.engine.state import EngineConfig, LocalEmits, PacketEmits
from shadow_tpu_torch.equeue import PAYLOAD_LANES
from shadow_tpu_torch.events import KIND_PACKET
from shadow_tpu_torch.simtime import NS_PER_MS
from shadow_tpu_torch.transport import tcp
from shadow_tpu_torch.transport.tcp import (
    KIND_TCP_FLUSH,
    KIND_TCP_TIMER,
    TCP_KIND_USER_BASE,
    TcpParams,
    TcpState,
)

KIND_CONNECT = TCP_KIND_USER_BASE  # client active-open trigger


@dataclasses.dataclass
class BulkState:
    tcp: TcpState
    conns_established: torch.Tensor  # [H] i64
    conns_closed: torch.Tensor  # [H] i64
    resets: torch.Tensor  # [H] i64


@dataclasses.dataclass(frozen=True)
class BulkTcpModel:
    num_hosts: int
    num_pairs: int
    total_bytes: int = 1 << 20
    port: int = 5001
    client_port: int = 40000
    start_ns: int = 1 * NS_PER_MS
    tcp_params: TcpParams = TcpParams()

    DRAWS_PER_EVENT = 0
    BOOTSTRAP_DRAWS = 0
    TCP_KIND_RANGE = (KIND_TCP_TIMER, TCP_KIND_USER_BASE)

    @property
    def LOCAL_EMITS(self):  # noqa: N802
        return self.tcp_params.local_lanes + 1  # + server echo-close flush

    @property
    def PACKET_EMITS(self):  # noqa: N802
        return self.tcp_params.packet_lanes

    @property
    def WIRE_HEADER_BYTES(self):  # noqa: N802
        return self.tcp_params.header_bytes

    def __post_init__(self):
        if 2 * self.num_pairs > self.num_hosts:
            raise ValueError("need num_hosts >= 2 * num_pairs")

    def _roles(self, host_id):
        is_client = host_id < self.num_pairs
        is_server = (host_id >= self.num_pairs) & (host_id < 2 * self.num_pairs)
        return is_client, is_server

    def init(self, device="cuda") -> BulkState:
        """The model's initial state on `device` (the card unless asked
        for the CPU): servers listen on slot 0."""
        dev = resolve_device(device)
        h = self.num_hosts
        ts = tcp.create(h, self.tcp_params, dev)
        host_id = torch.arange(h, dtype=torch.int32, device=dev)
        _, is_server = self._roles(host_id)
        ts = tcp.listen(
            ts,
            is_server,
            torch.zeros((h,), dtype=torch.int32, device=dev),
            torch.full((h,), self.port, dtype=torch.int32, device=dev),
        )
        z = torch.zeros((h,), dtype=torch.int64, device=dev)
        return BulkState(tcp=ts, conns_established=z, conns_closed=z.clone(),
                         resets=z.clone())

    def bootstrap(self, draw, host_id) -> LocalEmits:
        h = host_id.shape[0]
        dev = host_id.device
        is_client, _ = self._roles(host_id)
        return LocalEmits(
            valid=is_client[:, None],
            time=torch.full((h, 1), self.start_ns, dtype=torch.int64, device=dev),
            kind=torch.full((h, 1), KIND_CONNECT, dtype=torch.int32, device=dev),
            data=torch.zeros((h, 1, PAYLOAD_LANES), dtype=torch.int32, device=dev),
        )

    def handle(self, state: BulkState, ev, draw, cfg: EngineConfig, host_id):
        h = host_id.shape[0]
        dev = host_id.device
        p = self.tcp_params
        ts = state.tcp
        is_client, is_server = self._roles(host_id)

        # client connect: open, queue all bytes, half-close — the TCP output
        # pass in the same invocation emits the SYN
        m_conn = ev.valid & (ev.kind == KIND_CONNECT) & is_client
        app = tcp.AppOpen(
            mask=m_conn,
            slot=torch.zeros((h,), dtype=torch.int32, device=dev),
            lport=torch.full((h,), self.client_port, dtype=torch.int32, device=dev),
            rhost=(host_id + self.num_pairs).to(torch.int32),
            rport=torch.full((h,), self.port, dtype=torch.int32, device=dev),
            write_bytes=torch.full((h,), self.total_bytes, dtype=torch.int64, device=dev),
            close=torch.ones((h,), dtype=torch.bool, device=dev),
        )

        is_tcp_packet = ev.valid & (ev.kind == KIND_PACKET)
        slot, touched, v, emits, sig, _dopen = tcp.tcp_handle(
            ts, ev, host_id, p, is_tcp_packet, app=app
        )

        # server echo-close on EOF: close, then force an output pass via a
        # same-time flush event so the FIN actually goes out
        m_eof = sig.fin_seen & is_server
        eof_slot = torch.where(sig.slot >= 0, sig.slot, 0).to(torch.int32)
        v = tcp.view_close(v, m_eof)
        ts = tcp.commit_slot(ts, slot, touched, v)

        flush_data = torch.zeros((h, 1, PAYLOAD_LANES), dtype=torch.int32, device=dev)
        flush_data[:, 0, 0] = eof_slot
        lemits = LocalEmits(
            valid=torch.cat([emits.l_valid, m_eof[:, None]], dim=1),
            time=torch.cat([emits.l_time, ev.time[:, None]], dim=1),
            kind=torch.cat(
                [emits.l_kind,
                 torch.full((h, 1), KIND_TCP_FLUSH, dtype=torch.int32, device=dev)],
                dim=1,
            ),
            data=torch.cat([emits.l_data, flush_data], dim=1),
        )
        state = BulkState(
            tcp=ts,
            conns_established=state.conns_established + sig.established.to(torch.int64),
            conns_closed=state.conns_closed + sig.closed.to(torch.int64),
            resets=state.resets + sig.reset.to(torch.int64),
        )
        pemits = PacketEmits(
            valid=emits.p_valid, dst=emits.p_dst, data=emits.p_data, size=emits.p_size
        )
        return state, lemits, pemits
