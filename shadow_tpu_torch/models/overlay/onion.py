"""Onion routing: circuits, relay cells, EWMA scheduling (port of
shadow_tpu/models/overlay/onion.py, where the model is described in
full).

World layout (roles by host index, like tgen):

  hosts [0, NC)        clients — one circuit each, built at start:
                       client -> guard -> [middle ->] exit, the relays
                       drawn per client from the seeded per-host stream;
  hosts [NC, NC+NR)    relays — listen on the onion port; every adjacent
                       circuit hop is one TCP connection.

Circuit construction telescopes like Tor EXTEND cells: a SETUP control
cell (a raw packet tagged in LANE_APP) names the remaining hops; each
relay records (prev, next), opens its own TCP connection to the next hop
and forwards a SETUP with one hop peeled off. A hop connection carries
its global circuit id in the client-side port (PORT_CIRC_BASE + circ).

Relays bank per-connection `delivered` deltas into per-circuit pending
queues and a cell scheduler drains whole cells into the next hop,
picking the eligible circuit with the lowest EWMA activity score. The
exit turns request cells into `resp_cells` of response.

Clients pump like tgen streams; relays never pump (every relay event
runs the cell scheduler). The CUDA kernel (csrc/pump_megakernel.cu)
carries `pump_spec`'s two rules with num_clients, num_relays and
resp_span as arguments.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.engine.state import EngineConfig, LocalEmits, PacketEmits
from shadow_tpu_torch.equeue import PAYLOAD_LANES
from shadow_tpu_torch.events import KIND_PACKET
from shadow_tpu_torch.simtime import NS_PER_MS, NS_PER_US
from shadow_tpu_torch.transport import tcp
from shadow_tpu_torch.transport.header import LANE_APP
from shadow_tpu_torch.transport.tcp import (
    KIND_TCP_FLUSH,
    KIND_TCP_TIMER,
    TCP_KIND_USER_BASE,
    TcpParams,
    TcpState,
)

KIND_STREAM_START = TCP_KIND_USER_BASE  # client: write the next request
KIND_CIRC_BUILD = TCP_KIND_USER_BASE + 1  # client: draw path, open, SETUP
KIND_CELL_TICK = TCP_KIND_USER_BASE + 2  # relay: drain pending cells

# LANE_APP tag of SETUP control cells (TCP segments never write lane 5)
MAGIC_SETUP = 0x517

PORT_ONION = 9001  # every relay listens here (slot 0)
PORT_CIRC_BASE = 10_000  # hop lport = base + circuit id (u16 wire limit)

_I64_MAX = (1 << 63) - 1


@dataclasses.dataclass
class OnionState:
    tcp: TcpState
    # per-relay circuit table, [H, C] (clients leave theirs empty)
    circ_id: torch.Tensor  # i32 global circuit id (-1 free row)
    prev_host: torch.Tensor  # i32 hop toward the client
    next_host: torch.Tensor  # i32 hop toward the exit (-1 = this IS the exit)
    in_slot: torch.Tensor  # i32 TCP slot of the prev-hop connection (-1 unset)
    out_slot: torch.Tensor  # i32 TCP slot of the next-hop connection (-1 exit)
    pend_up: torch.Tensor  # i64 bytes queued toward the exit
    pend_down: torch.Tensor  # i64 bytes queued toward the client
    ewma: torch.Tensor  # i64 decayed cells-served activity score
    # per-host
    tick_armed: torch.Tensor  # [H] bool a CELL_TICK is pending
    circuits_built: torch.Tensor  # [H] i64 rows allocated (relay)
    circuits_rejected: torch.Tensor  # [H] i64 SETUP dropped: table/slots full
    cells_relayed: torch.Tensor  # [H] i64 cells forwarded by the scheduler
    requests_served: torch.Tensor  # [H] i64 exit: requests turned into responses
    streams_started: torch.Tensor  # [H] i64 client requests written
    streams_done: torch.Tensor  # [H] i64 client responses fully received
    bytes_down: torch.Tensor  # [H] i64 client response bytes consumed


@dataclasses.dataclass(frozen=True)
class OnionModel:
    num_hosts: int
    num_clients: int
    num_relays: int
    hops: int = 3  # circuit length: guard [, middle [, exit]]
    cell_bytes: int = 512  # fixed relay cell size
    req_cells: int = 2  # request size, cells
    resp_cells: int = 40  # response size, cells
    pause_ns: int = 200 * NS_PER_MS  # client think time between streams
    start_ns: int = 1 * NS_PER_MS
    circuits_per_relay: int = 8  # C: circuit table rows per relay
    cells_per_service: int = 4  # cells one scheduler service may move
    inflight_cells: int = 16  # per-hop-connection unacked-byte cap, cells
    tick_ns: int = 100 * NS_PER_US  # scheduler self-clock when backlogged
    ewma_shift: int = 3  # activity decay: ewma -= ewma >> shift per service
    port: int = PORT_ONION
    tcp_params: TcpParams = None  # derived in __post_init__ when None

    DRAWS_PER_EVENT = 3  # (guard, middle, exit) on KIND_CIRC_BUILD
    BOOTSTRAP_DRAWS = 0
    TCP_KIND_RANGE = (KIND_TCP_TIMER, TCP_KIND_USER_BASE)

    def __post_init__(self):
        if self.tcp_params is None:
            # one listener + an inbound child and an outbound connection
            # per circuit row
            object.__setattr__(
                self, "tcp_params", TcpParams(num_sockets=1 + 2 * self.circuits_per_relay)
            )
        if self.num_clients + self.num_relays > self.num_hosts:
            raise ValueError("need num_hosts >= clients + relays")
        if self.num_clients < 1 or self.num_relays < 1:
            raise ValueError("need at least one client and one relay")
        if not 1 <= self.hops <= 3:
            raise ValueError("hops must be 1, 2, or 3")
        if self.num_relays < self.hops:
            raise ValueError(
                f"hops={self.hops} needs at least {self.hops} relays "
                f"(got {self.num_relays}): circuit relays are distinct"
            )
        if self.cell_bytes < 1 or self.req_cells < 1 or self.resp_cells < 1:
            raise ValueError("cell/req_cells/resp_cells must be >= 1")
        if self.num_clients > 0xFFFF - PORT_CIRC_BASE:
            raise ValueError(
                f"at most {0xFFFF - PORT_CIRC_BASE} clients: the circuit id "
                "rides the 16-bit hop source port"
            )
        if self.tcp_params.num_sockets < 3:
            raise ValueError("num_sockets must be >= 3 (listener + one hop)")

    @property
    def LOCAL_EMITS(self):  # noqa: N802
        # tcp (flush cont. + timer) + scheduler flush + tick + next-stream
        return self.tcp_params.local_lanes + 3

    @property
    def PACKET_EMITS(self):  # noqa: N802
        # tcp data/control lanes first (the pump's loss-draw lane indices
        # must match the handler's), SETUP control cell last
        return self.tcp_params.packet_lanes + 1

    @property
    def WIRE_HEADER_BYTES(self):  # noqa: N802
        return self.tcp_params.header_bytes

    @property
    def req_span(self) -> int:
        return self.req_cells * self.cell_bytes

    @property
    def resp_span(self) -> int:
        return self.resp_cells * self.cell_bytes

    def _roles(self, host_id):
        is_client = host_id < self.num_clients
        is_relay = (host_id >= self.num_clients) & (
            host_id < self.num_clients + self.num_relays
        )
        return is_client, is_relay

    @property
    def pump_spec(self):
        """Pump contract: relays never pump; clients pump like tgen,
        vetoing only the event whose delivered crossing completes a
        response (the next-stream trigger). apply: the client download
        byte counter."""
        from shadow_tpu_torch.engine.pump import TcpPumpSpec

        nc, nr = self.num_clients, self.num_relays
        span = self.resp_span

        def block(ms, host_id, v_st, v_snd_end, delivered_new, delta):
            is_relay = (host_id >= nc) & (host_id < nc + nr)
            done_edge = (
                (host_id < nc)
                & (ms.streams_done < ms.streams_started)
                & (delivered_new >= ms.streams_started * span)
            )
            return is_relay | done_edge

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

    def init(self, device="cuda") -> OnionState:
        """The model's initial state on `device` (the card unless asked
        for the CPU): relays listen on slot 0."""
        dev = resolve_device(device)
        h, c = self.num_hosts, self.circuits_per_relay
        ts = tcp.create(h, self.tcp_params, dev)
        host_id = torch.arange(h, dtype=torch.int32, device=dev)
        _, is_relay = self._roles(host_id)
        ts = tcp.listen(
            ts,
            is_relay,
            torch.zeros((h,), dtype=torch.int32, device=dev),
            torch.full((h,), self.port, dtype=torch.int32, device=dev),
        )

        def neg():
            return torch.full((h, c), -1, dtype=torch.int32, device=dev)

        def z64c():
            return torch.zeros((h, c), dtype=torch.int64, device=dev)

        def z64():
            return torch.zeros((h,), dtype=torch.int64, device=dev)

        return OnionState(
            tcp=ts, circ_id=neg(), prev_host=neg(), next_host=neg(), in_slot=neg(),
            out_slot=neg(), pend_up=z64c(), pend_down=z64c(), ewma=z64c(),
            tick_armed=torch.zeros((h,), dtype=torch.bool, device=dev),
            circuits_built=z64(), circuits_rejected=z64(), cells_relayed=z64(),
            requests_served=z64(), streams_started=z64(), streams_done=z64(),
            bytes_down=z64(),
        )

    def bootstrap(self, draw, host_id) -> LocalEmits:
        """Clients schedule their circuit build; path draws happen at the
        build event (bootstrap cannot write model state)."""
        h = host_id.shape[0]
        dev = host_id.device
        is_client, _ = self._roles(host_id)
        return LocalEmits(
            valid=is_client[:, None],
            time=torch.full((h, 1), self.start_ns, dtype=torch.int64, device=dev),
            kind=torch.full((h, 1), KIND_CIRC_BUILD, dtype=torch.int32, device=dev),
            data=torch.zeros((h, 1, PAYLOAD_LANES), dtype=torch.int32, device=dev),
        )

    def _draw_path(self, draw, host_id):
        """(guard, second, third) relay host ids, distinct, from the
        per-host stream — all three draws always consumed (fixed stride)."""
        nc, nr = self.num_clients, self.num_relays
        i32 = torch.int32
        g = draw.uniform_int(0, 0, nr).to(i32)
        u1 = draw.uniform_int(1, 0, max(nr - 1, 1)).to(i32)
        m = u1 + (u1 >= g).to(i32)
        u2 = draw.uniform_int(2, 0, max(nr - 2, 1)).to(i32)
        lo, hi = torch.minimum(g, m), torch.maximum(g, m)
        e = u2 + (u2 >= lo).to(i32)
        e = e + (e >= hi).to(i32)
        return nc + g, nc + m, nc + e

    @staticmethod
    def _slot_field(a, slot):
        """a[h, slot[h, c]] per circuit row; 0 where slot < 0. [H,S]x[H,C]."""
        s = a.shape[1]
        oh = slot[:, :, None] == torch.arange(s, dtype=torch.int32, device=a.device)[None, None, :]
        return torch.where(oh, a[:, None, :], 0).sum(dim=2).to(a.dtype)

    def handle(self, state: OnionState, ev, draw, cfg: EngineConfig, host_id):
        h = host_id.shape[0]
        dev = host_id.device
        i32, i64 = torch.int32, torch.int64
        W = torch.where
        p = self.tcp_params
        c = self.circuits_per_relay
        cell = self.cell_bytes
        is_client, is_relay = self._roles(host_id)
        row_idx = torch.arange(c, dtype=i32, device=dev)[None, :]

        is_pkt = ev.valid & (ev.kind == KIND_PACKET)
        is_setup = is_pkt & (ev.data[:, LANE_APP] == MAGIC_SETUP)
        is_tcp_packet = is_pkt & ~is_setup

        # --- client: build the circuit (path draws + open + SETUP) -------
        m_build = ev.valid & (ev.kind == KIND_CIRC_BUILD) & is_client
        guard_h, second_h, third_h = self._draw_path(draw, host_id)
        neg1 = torch.full((h,), -1, dtype=i32, device=dev)
        if self.hops == 1:
            next_for_guard, next_next = neg1, neg1
        elif self.hops == 2:
            next_for_guard, next_next = second_h, neg1
        else:
            next_for_guard, next_next = second_h, third_h

        # --- relay: SETUP arrival — allocate a circuit row, extend -------
        m_setup = is_setup & is_relay
        s_circ = ev.data[:, 1]
        s_next = ev.data[:, 2]
        s_next2 = ev.data[:, 3]
        free_rows = state.circ_id < 0
        free_row = torch.argmax(free_rows.to(i32), dim=1).to(i32)
        has_row = free_rows.any(dim=1)
        free_slots = state.tcp.st == tcp.CLOSED
        free_slot = torch.argmax(free_slots.to(i32), dim=1).to(i32)
        has_slot = free_slots.any(dim=1)
        needs_conn = s_next >= 0
        can_setup = m_setup & has_row & (has_slot | ~needs_conn)
        row_oh = (row_idx == free_row[:, None]) & can_setup[:, None]
        state = dataclasses.replace(
            state,
            circ_id=W(row_oh, s_circ[:, None], state.circ_id),
            prev_host=W(row_oh, ev.src_host[:, None], state.prev_host),
            next_host=W(row_oh, s_next[:, None], state.next_host),
            in_slot=W(row_oh, -1, state.in_slot),
            out_slot=W(row_oh, W(needs_conn, free_slot, -1)[:, None], state.out_slot),
            pend_up=W(row_oh, 0, state.pend_up),
            pend_down=W(row_oh, 0, state.pend_down),
            ewma=W(row_oh, 0, state.ewma),
            circuits_built=state.circuits_built + can_setup.to(i64),
            circuits_rejected=state.circuits_rejected + (m_setup & ~can_setup).to(i64),
            streams_started=state.streams_started + m_build.to(i64),
        )

        # --- fused app intents: client open-with-request / relay extend --
        # app.slot doubles as the default focus slot for non-TCP events,
        # so clients pin it to their one circuit connection (slot 0)
        m_extend = can_setup & needs_conn
        circ_of = W(m_build, host_id, s_circ)
        app = tcp.AppOpen(
            mask=m_build | m_extend,
            slot=W(is_client, 0, free_slot).to(i32),
            lport=(PORT_CIRC_BASE + circ_of).to(i32),
            rhost=W(m_build, guard_h, s_next).to(i32),
            rport=torch.full((h,), self.port, dtype=i32, device=dev),
            write_bytes=W(m_build, self.req_span, 0).to(i64),
            close=torch.zeros((h,), dtype=torch.bool, device=dev),
        )

        ts = state.tcp
        slot, touched, v, emits, sig, delivered_open = tcp.tcp_handle(
            ts, ev, host_id, p, is_tcp_packet, app=app
        )

        # --- classify the focus connection; bank delivered deltas --------
        delta = W(touched, v.delivered - delivered_open, 0)
        acceptor = touched & (v.lport == self.port)  # child from prev hop
        initiator = touched & (v.rport == self.port)  # our conn to next hop
        c_focus = W(acceptor, v.rport, v.lport) - PORT_CIRC_BASE
        focus_row = (
            (state.circ_id == c_focus[:, None])
            & (c_focus >= 0)[:, None]
            & is_relay[:, None]
        )
        assign_in = focus_row & acceptor[:, None] & (state.in_slot < 0)
        in_slot = W(assign_in, slot[:, None], state.in_slot)
        pend_up = state.pend_up + W(focus_row & acceptor[:, None], delta[:, None], 0)
        pend_down = state.pend_down + W(focus_row & initiator[:, None], delta[:, None], 0)

        # --- exit: whole requests become responses -----------------------
        is_exit_row = (state.circ_id >= 0) & (state.next_host < 0)
        req_done = W(is_exit_row, pend_up // self.req_span, 0)
        pend_up = pend_up - req_done * self.req_span
        pend_down = pend_down + req_done * self.resp_span
        state = dataclasses.replace(
            state, requests_served=state.requests_served + req_done.sum(dim=1)
        )

        # --- client bookkeeping: response bytes, stream completion -------
        bytes_down = state.bytes_down + W(is_client & touched, delta, 0)
        m_done = (
            is_client
            & (state.streams_done < state.streams_started)
            & (bytes_down >= state.streams_started * self.resp_span)
        )
        # next request on the existing circuit (streams reuse circuits)
        m_next = ev.valid & (ev.kind == KIND_STREAM_START) & is_client
        v = tcp.view_write(v, m_next, self.req_span)
        state = dataclasses.replace(
            state,
            bytes_down=bytes_down,
            streams_done=state.streams_done + m_done.to(i64),
            streams_started=state.streams_started + m_next.to(i64),
        )

        # --- cell scheduler: one EWMA-weighted service per relay event ---
        in_free = self._slot_field(ts.snd_end, in_slot) - self._slot_field(ts.snd_una, in_slot)
        out_free = self._slot_field(ts.snd_end, state.out_slot) - self._slot_field(
            ts.snd_una, state.out_slot
        )
        cap = self.inflight_cells * cell
        live = state.circ_id >= 0
        elig_up = live & (pend_up >= cell) & (state.out_slot >= 0) & (out_free < cap)
        elig_down = live & (pend_down >= cell) & (in_slot >= 0) & (in_free < cap)
        elig = elig_up | elig_down
        m_evt = ev.valid & is_relay
        m_serve = m_evt & elig.any(dim=1)
        score = W(elig, state.ewma, _I64_MAX)
        r_sel = torch.argmin(score, dim=1).to(i32)  # ties: low row
        sel_oh = row_idx == r_sel[:, None]
        up_sel = (sel_oh & elig_up).any(dim=1)  # up wins when both
        pend_sel = W(sel_oh, W(up_sel[:, None], pend_up, pend_down), 0).sum(dim=1)
        n_cells = W(m_serve, torch.clamp(pend_sel // cell, max=self.cells_per_service), 0)
        serve_bytes = n_cells * cell
        target_slot = W(
            sel_oh, W(up_sel[:, None], state.out_slot, in_slot), 0
        ).sum(dim=1).to(i32)
        dec_up = sel_oh & up_sel[:, None] & m_serve[:, None]
        dec_down = sel_oh & ~up_sel[:, None] & m_serve[:, None]
        pend_up = pend_up - W(dec_up, serve_bytes[:, None], 0)
        pend_down = pend_down - W(dec_down, serve_bytes[:, None], 0)
        ewma = W(m_serve[:, None], state.ewma - (state.ewma >> self.ewma_shift), state.ewma)
        ewma = ewma + W(dec_up | dec_down, n_cells[:, None], 0)

        # --- commit TCP: the event's fused view, then the service write --
        ts = tcp.commit_slot(ts, slot, touched | m_next, v)
        ts = tcp.app_write(
            ts, m_serve, torch.clamp(target_slot, 0, p.num_sockets - 1), serve_bytes
        )

        # --- scheduler self-clock: keep draining when backlog remains ----
        m_tick = ev.valid & (ev.kind == KIND_CELL_TICK)
        armed = state.tick_armed & ~m_tick
        backlog = (
            (live & (pend_up >= cell) & (state.out_slot >= 0))
            | (live & (pend_down >= cell) & (in_slot >= 0))
        ).any(dim=1)
        arm_now = m_evt & backlog & ~armed
        state = dataclasses.replace(
            state,
            tcp=ts,
            in_slot=in_slot,
            pend_up=pend_up,
            pend_down=pend_down,
            ewma=ewma,
            tick_armed=armed | arm_now,
            cells_relayed=state.cells_relayed + n_cells,
        )

        # --- local lanes: tcp's two + flush / tick / next-stream ---------
        def col(x, dt):
            return torch.as_tensor(x, dtype=dt, device=dev).expand(h)[:, None]

        flush_data = torch.zeros((h, 1, PAYLOAD_LANES), dtype=i32, device=dev)
        flush_data[:, 0, 0] = W(m_serve, target_slot, 0)
        zero_data = torch.zeros((h, 1, PAYLOAD_LANES), dtype=i32, device=dev)
        lemits = LocalEmits(
            valid=torch.cat(
                [emits.l_valid, (m_serve | m_next)[:, None], arm_now[:, None],
                 m_done[:, None]], dim=1),
            time=torch.cat(
                [emits.l_time, ev.time[:, None], (ev.time + self.tick_ns)[:, None],
                 (ev.time + self.pause_ns)[:, None]], dim=1),
            kind=torch.cat(
                [emits.l_kind, col(KIND_TCP_FLUSH, i32), col(KIND_CELL_TICK, i32),
                 col(KIND_STREAM_START, i32)], dim=1),
            data=torch.cat([emits.l_data, flush_data, zero_data, zero_data], dim=1),
        )

        # --- packet lanes: tcp first (pump lane-index contract), SETUP
        # control cell last -----------------------------------------------
        s_data = torch.zeros((h, PAYLOAD_LANES), dtype=i32, device=dev)
        s_data[:, 1] = circ_of
        s_data[:, 2] = W(m_build, next_for_guard, s_next2)
        s_data[:, 3] = W(m_build, next_next, -1)
        s_data[:, LANE_APP] = MAGIC_SETUP
        pemits = PacketEmits(
            valid=torch.cat([emits.p_valid, (m_build | m_extend)[:, None]], dim=1),
            dst=torch.cat(
                [emits.p_dst, W(m_build, guard_h, s_next).to(i32)[:, None]], dim=1),
            data=torch.cat([emits.p_data, s_data[:, None, :]], dim=1),
            size=torch.cat([emits.p_size, col(self.cell_bytes, i32)], dim=1),
        )
        return state, lemits, pemits
