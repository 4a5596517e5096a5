"""Vectorized TCP: the flow table as [H, S] tensor rows (port of
shadow_tpu/transport/tcp.py).

Every field of every socket of every host lives in one struct of
tensors; segment arrival, timer expiry and app demand are branch-free
masked updates over one focus slot per host. Semantics are the
reference's: the RFC 793 state machine with listener child slots, byte
windows, out-of-order ranges, RFC 6298 RTT/RTO in integer ns with Karn's
rule, Reno/NewReno and a SACK scoreboard. Sequence numbers are absolute
i64 byte offsets; the wire carries the low 32 bits.

Integer care taken over the reference's jnp code: `//` is a floor
division in both; every divisor is guarded (max(cwnd, 1)) because both
branches of a where are evaluated.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.equeue import PAYLOAD_LANES
from shadow_tpu_torch.events import KIND_MODEL_BASE
from shadow_tpu_torch.simtime import NS_PER_MS, NS_PER_SEC, TIME_MAX
from shadow_tpu_torch.transport.header import (
    FLAG_ACK,
    FLAG_FIN,
    FLAG_RST,
    FLAG_SYN,
    LANE_ACK,
    LANE_FLAGS_LEN,
    LANE_PORTS,
    LANE_SACK_E,
    LANE_SACK_S,
    LANE_SEQ,
    LANE_WND,
    pack_flags_len,
    pack_ports,
    to_wire32,
    unpack_flags_len,
    unpack_ports,
    unwrap32,
)

CLOSED = 0
LISTEN = 1
SYNSENT = 2
SYNRECEIVED = 3
ESTABLISHED = 4
FINWAIT1 = 5
FINWAIT2 = 6
CLOSING = 7
TIMEWAIT = 8
CLOSEWAIT = 9
LASTACK = 10

KIND_TCP_TIMER = KIND_MODEL_BASE + 0
KIND_TCP_FLUSH = KIND_MODEL_BASE + 1
TCP_KIND_USER_BASE = KIND_MODEL_BASE + 8

_W = torch.where


@dataclasses.dataclass(frozen=True)
class TcpParams:
    """Static TCP parameters (units: bytes, ns)."""

    num_sockets: int = 4
    mss: int = 1460
    header_bytes: int = 40
    rcv_wnd: int = 256 * 1024
    init_cwnd_segs: int = 10
    rto_init_ns: int = NS_PER_SEC
    rto_min_ns: int = 200 * NS_PER_MS
    rto_max_ns: int = 60 * NS_PER_SEC
    granularity_ns: int = NS_PER_MS
    timewait_ns: int = 60 * NS_PER_SEC
    ooo_ranges: int = 4
    segs_per_flush: int = 4
    use_sack: bool = True

    @property
    def packet_lanes(self) -> int:
        return self.segs_per_flush + 1

    @property
    def local_lanes(self) -> int:
        return 2


@dataclasses.dataclass
class TcpState:
    """All fields [H, S] unless noted. i64 seq fields are absolute offsets."""

    st: torch.Tensor  # i32
    lport: torch.Tensor  # i32
    rport: torch.Tensor  # i32
    rhost: torch.Tensor  # i32 (-1 none)
    snd_una: torch.Tensor
    snd_nxt: torch.Tensor
    snd_max: torch.Tensor
    snd_end: torch.Tensor
    fin_pending: torch.Tensor  # bool
    fin_sent: torch.Tensor  # bool
    peer_wnd: torch.Tensor
    rcv_nxt: torch.Tensor
    rcv_fin: torch.Tensor
    delivered: torch.Tensor
    ooo: torch.Tensor  # [H, S, R, 2] i64
    sacked: torch.Tensor  # [H, S, R, 2] i64
    rtx_mark: torch.Tensor
    cwnd: torch.Tensor
    ssthresh: torch.Tensor
    dupacks: torch.Tensor  # i32
    recover: torch.Tensor
    in_rec: torch.Tensor  # bool
    srtt: torch.Tensor
    rttvar: torch.Tensor
    rto: torch.Tensor
    rtt_pending: torch.Tensor  # bool
    rtt_seq: torch.Tensor
    rtt_ts: torch.Tensor
    rto_expire: torch.Tensor
    backoff: torch.Tensor  # i32
    tev_time: torch.Tensor
    retransmits: torch.Tensor
    segs_in: torch.Tensor
    segs_out: torch.Tensor


def create(num_hosts: int, p: TcpParams, device="cpu") -> TcpState:
    h, s, r = num_hosts, p.num_sockets, p.ooo_ranges

    def full(v, dt=torch.int64):
        return torch.full((h, s), v, dtype=dt, device=device)

    def z(dt=torch.int64):
        return full(0, dt)

    return TcpState(
        st=z(torch.int32),
        lport=z(torch.int32),
        rport=z(torch.int32),
        rhost=full(-1, torch.int32),
        snd_una=z(),
        snd_nxt=z(),
        snd_max=z(),
        snd_end=full(1),
        fin_pending=z(torch.bool),
        fin_sent=z(torch.bool),
        peer_wnd=full(p.rcv_wnd),
        rcv_nxt=z(),
        rcv_fin=full(-1),
        delivered=z(),
        ooo=torch.full((h, s, r, 2), -1, dtype=torch.int64, device=device),
        sacked=torch.full((h, s, r, 2), -1, dtype=torch.int64, device=device),
        rtx_mark=z(),
        cwnd=full(p.init_cwnd_segs * p.mss),
        ssthresh=full(1 << 40),
        dupacks=z(torch.int32),
        recover=z(),
        in_rec=z(torch.bool),
        srtt=full(-1),
        rttvar=z(),
        rto=full(p.rto_init_ns),
        rtt_pending=z(torch.bool),
        rtt_seq=z(),
        rtt_ts=z(),
        rto_expire=full(TIME_MAX),
        backoff=z(torch.int32),
        tev_time=full(TIME_MAX),
        retransmits=z(),
        segs_in=z(),
        segs_out=z(),
    )


# --- slot gather/scatter -------------------------------------------------


def _g(a: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """a[h, slot[h], ...] for every host h (slot always in [0, S))."""
    idx = slot.to(torch.int64).reshape((-1, 1) + (1,) * (a.ndim - 2))
    idx = idx.expand((a.shape[0], 1) + tuple(a.shape[2:]))
    return torch.gather(a, 1, idx)[:, 0]


def _s(a, slot, mask, new):
    """a[h, slot[h], ...] = new[h, ...] where mask[h]."""
    onehot = (torch.arange(a.shape[1], device=a.device)[None, :] == slot[:, None]) & mask[:, None]
    oh = onehot.reshape(onehot.shape + (1,) * (a.ndim - 2))
    return _W(oh, new.unsqueeze(1), a)


def _fields(ts: TcpState):
    return [f.name for f in dataclasses.fields(ts)]


def gather_slot(ts: TcpState, slot) -> TcpState:
    return TcpState(**{n: _g(getattr(ts, n), slot) for n in _fields(ts)})


def scatter_slot(ts: TcpState, slot, mask, view: TcpState) -> TcpState:
    return TcpState(
        **{n: _s(getattr(ts, n), slot, mask, getattr(view, n)) for n in _fields(ts)}
    )


def _bcast(m, cur):
    return m.reshape(m.shape + (1,) * (cur.ndim - m.ndim))


def _reset_view(v: TcpState, m, p: TcpParams) -> TcpState:
    """Reinitialize every per-connection field of the view where `m`."""

    def w(cur, fresh):
        return _W(_bcast(m, cur), torch.as_tensor(fresh, dtype=cur.dtype, device=cur.device), cur)

    return dataclasses.replace(
        v,
        snd_una=w(v.snd_una, 0),
        snd_nxt=w(v.snd_nxt, 0),
        snd_max=w(v.snd_max, 0),
        snd_end=w(v.snd_end, 1),
        fin_pending=w(v.fin_pending, False),
        fin_sent=w(v.fin_sent, False),
        peer_wnd=w(v.peer_wnd, p.rcv_wnd),
        rcv_nxt=w(v.rcv_nxt, 0),
        rcv_fin=w(v.rcv_fin, -1),
        delivered=w(v.delivered, 0),
        ooo=w(v.ooo, -1),
        sacked=w(v.sacked, -1),
        rtx_mark=w(v.rtx_mark, 0),
        cwnd=w(v.cwnd, p.init_cwnd_segs * p.mss),
        ssthresh=w(v.ssthresh, 1 << 40),
        dupacks=w(v.dupacks, 0),
        recover=w(v.recover, 0),
        in_rec=w(v.in_rec, False),
        srtt=w(v.srtt, -1),
        rttvar=w(v.rttvar, 0),
        rto=w(v.rto, p.rto_init_ns),
        rtt_pending=w(v.rtt_pending, False),
        rtt_seq=w(v.rtt_seq, 0),
        rtt_ts=w(v.rtt_ts, 0),
        rto_expire=w(v.rto_expire, TIME_MAX),
        backoff=w(v.backoff, 0),
    )


# --- app-side operations --------------------------------------------------


def listen(ts: TcpState, mask, slot, port) -> TcpState:
    v = gather_slot(ts, slot)
    v = dataclasses.replace(
        v, st=_W(mask, LISTEN, v.st), lport=_W(mask, port, v.lport)
    )
    return scatter_slot(ts, slot, mask, v)


def connect(ts: TcpState, mask, slot, lport, rhost, rport, p: TcpParams) -> TcpState:
    v = gather_slot(ts, slot)
    m = mask & (v.st == CLOSED)
    v = _reset_view(v, m, p)
    v = dataclasses.replace(
        v,
        st=_W(m, SYNSENT, v.st),
        lport=_W(m, lport, v.lport),
        rport=_W(m, rport, v.rport),
        rhost=_W(m, rhost, v.rhost),
    )
    return scatter_slot(ts, slot, m, v)


def app_write(ts: TcpState, mask, slot, nbytes) -> TcpState:
    v = gather_slot(ts, slot)
    m = mask & (v.st != CLOSED) & (v.st != LISTEN) & ~v.fin_pending
    v = dataclasses.replace(v, snd_end=_W(m, v.snd_end + nbytes, v.snd_end))
    return scatter_slot(ts, slot, m, v)


def app_close(ts: TcpState, mask, slot) -> TcpState:
    v = gather_slot(ts, slot)
    m = mask & (v.st != CLOSED) & (v.st != LISTEN)
    v = dataclasses.replace(v, fin_pending=_W(m, True, v.fin_pending))
    return scatter_slot(ts, slot, m, v)


# --- RTT / RTO (RFC 6298) -------------------------------------------------


def _rtt_update(v: TcpState, m, rtt, p: TcpParams) -> TcpState:
    first = v.srtt < 0
    rttvar1 = _W(first, rtt // 2, (3 * v.rttvar + torch.abs(v.srtt - rtt)) // 4)
    srtt1 = _W(first, rtt, (7 * v.srtt + rtt) // 8)
    rto1 = torch.clamp(
        srtt1 + torch.clamp(4 * rttvar1, min=p.granularity_ns), p.rto_min_ns, p.rto_max_ns
    )
    return dataclasses.replace(
        v,
        srtt=_W(m, srtt1, v.srtt),
        rttvar=_W(m, rttvar1, v.rttvar),
        rto=_W(m, rto1, v.rto),
        rtt_pending=_W(m, False, v.rtt_pending),
    )


# --- out-of-order range set ------------------------------------------------


def _ooo_absorb(rcv_nxt, ooo, m):
    """Advance rcv_nxt over any buffered ranges it now reaches; clear them."""
    r = ooo.shape[1]
    for _ in range(r):
        start, end = ooo[:, :, 0], ooo[:, :, 1]
        hit = m[:, None] & (start >= 0) & (start <= rcv_nxt[:, None])
        reach = _W(hit, end, -1).amax(dim=1)
        rcv_nxt = torch.maximum(rcv_nxt, reach)
        ooo = _W(hit[:, :, None], -1, ooo)
    return rcv_nxt, ooo


def _ooo_insert(ooo, m, s, e):
    """Merge-insert [s, e) into the range set; drop if full and disjoint."""
    start, end = ooo[:, :, 0], ooo[:, :, 1]
    empty = start < 0
    overlap = m[:, None] & ~empty & (s[:, None] <= end) & (e[:, None] >= start)
    ms = torch.minimum(s, _W(overlap, start, 1 << 60).amin(dim=1))
    me = torch.maximum(e, _W(overlap, end, -1).amax(dim=1))
    avail = overlap | (empty & m[:, None])
    ins = torch.argmax(avail.to(torch.int32), dim=1)
    can = avail.any(dim=1) & m
    cleared = _W(overlap[:, :, None], -1, ooo)
    merged = torch.stack([ms, me], dim=-1)
    at = (torch.arange(ooo.shape[1], device=ooo.device)[None, :] == ins[:, None]) & can[:, None]
    return _W(at[:, :, None], merged[:, None, :], cleared)


# --- fused-view app intents -------------------------------------------------


@dataclasses.dataclass
class AppOpen:
    """Pre-TCP application intents for this event (connect + optional
    write/close on `slot` where `mask`)."""

    mask: torch.Tensor  # [H] bool
    slot: torch.Tensor  # [H] i32
    lport: torch.Tensor  # [H] i32
    rhost: torch.Tensor  # [H] i32
    rport: torch.Tensor  # [H] i32
    write_bytes: torch.Tensor  # [H] i64
    close: torch.Tensor  # [H] bool


def no_app_open(h: int, device="cpu") -> AppOpen:
    z32 = torch.zeros((h,), dtype=torch.int32, device=device)
    zb = torch.zeros((h,), dtype=torch.bool, device=device)
    return AppOpen(
        mask=zb, slot=z32, lport=z32, rhost=z32, rport=z32,
        write_bytes=torch.zeros((h,), dtype=torch.int64, device=device), close=zb,
    )


def view_write(v: TcpState, mask, nbytes) -> TcpState:
    m = mask & (v.st != CLOSED) & (v.st != LISTEN) & ~v.fin_pending
    return dataclasses.replace(v, snd_end=_W(m, v.snd_end + nbytes, v.snd_end))


def view_close(v: TcpState, mask) -> TcpState:
    m = mask & (v.st != CLOSED) & (v.st != LISTEN)
    return dataclasses.replace(v, fin_pending=_W(m, True, v.fin_pending))


def commit_slot(ts: TcpState, slot, touched, view: TcpState) -> TcpState:
    return scatter_slot(ts, slot, touched, view)


# --- emissions --------------------------------------------------------------


@dataclasses.dataclass
class TcpEmits:
    """Packet lanes [H, EP] + local-event lanes [H, 2]."""

    p_valid: torch.Tensor
    p_dst: torch.Tensor
    p_data: torch.Tensor
    p_size: torch.Tensor
    l_valid: torch.Tensor
    l_time: torch.Tensor
    l_kind: torch.Tensor
    l_data: torch.Tensor


@dataclasses.dataclass
class TcpSignals:
    slot: torch.Tensor  # i32 (-1 none)
    established: torch.Tensor
    fin_seen: torch.Tensor
    closed: torch.Tensor
    reset: torch.Tensor


def _mk_seg(lport, rport, seq, ack, flags, plen, wnd, sack_s=None, sack_e=None):
    """One segment's payload lanes ([H, PAYLOAD_LANES]); lane 5 stays 0."""
    cols = [
        pack_ports(lport, rport),
        to_wire32(seq),
        to_wire32(ack),
        pack_flags_len(flags, plen),
        wnd.to(torch.int32),
        torch.zeros_like(lport, dtype=torch.int32),
    ]
    if sack_s is not None:
        cols += [to_wire32(sack_s), to_wire32(sack_e)]
    else:
        cols += [torch.zeros_like(cols[-1])] * 2
    return torch.stack(cols, dim=1)


def _first_unsacked(hole, sacked, rounds):
    """March `hole` over scoreboard ranges covering it (R passes)."""
    for _ in range(rounds):
        cover = (
            (sacked[:, :, 0] >= 0)
            & (sacked[:, :, 0] <= hole[:, None])
            & (sacked[:, :, 1] > hole[:, None])
        )
        reach = _W(cover, sacked[:, :, 1], -1).amax(dim=1)
        hole = torch.maximum(hole, reach)
    return hole


def tcp_handle(ts: TcpState, ev, host_id, p: TcpParams, is_tcp_packet, app=None):
    """Process one event per host through the TCP machine on one fused
    slot view. Returns (focus_slot, touched, view, TcpEmits, TcpSignals,
    delivered_open); the caller must commit_slot(ts, focus, touched, view)."""
    h = host_id.shape[0]
    dev = host_id.device
    i64, i32 = torch.int64, torch.int32
    now = ev.time
    mss = p.mss
    if app is None:
        app = no_app_open(h, dev)
    zb = torch.zeros((h,), dtype=torch.bool, device=dev)

    m_rx = is_tcp_packet & ev.valid
    m_tmr = ev.valid & (ev.kind == KIND_TCP_TIMER)
    m_flush = ev.valid & (ev.kind == KIND_TCP_FLUSH)

    # ---------------- RX: demux ----------------
    sport, dport = unpack_ports(ev.data[:, LANE_PORTS])
    src = ev.src_host
    exact = (
        (ts.st != CLOSED)
        & (ts.st != LISTEN)
        & (ts.lport == dport[:, None])
        & (ts.rhost == src[:, None])
        & (ts.rport == sport[:, None])
    )
    lsn = (ts.st == LISTEN) & (ts.lport == dport[:, None])
    score = exact.to(i32) * 2 + lsn.to(i32)
    rx_slot = torch.argmax(score, dim=1).to(i32)
    rx_match = m_rx & (score.amax(dim=1) > 0)
    rx_exact = m_rx & exact.any(dim=1)
    rx_listen = rx_match & ~rx_exact

    flags, plen = unpack_flags_len(ev.data[:, LANE_FLAGS_LEN])
    f_syn = (flags & FLAG_SYN) != 0
    f_ack = (flags & FLAG_ACK) != 0
    f_fin = (flags & FLAG_FIN) != 0
    f_rst = (flags & FLAG_RST) != 0
    wnd = ev.data[:, LANE_WND].to(i64)

    # passive open: SYN to a listener spawns a child slot
    m_spawn = rx_listen & f_syn & ~f_ack
    free = ts.st == CLOSED
    child = torch.argmax(free.to(i32), dim=1).to(i32)
    m_spawn = m_spawn & free.any(dim=1)
    act_slot = _W(m_spawn, child, rx_slot)
    m_act = rx_exact | m_spawn

    t_slot = torch.clamp(ev.data[:, 0], 0, p.num_sockets - 1)
    focus = _W(m_act, act_slot, _W(m_tmr | m_flush, t_slot, app.slot)).to(i32)
    v = gather_slot(ts, focus)

    v = _reset_view(v, m_spawn, p)
    v = dataclasses.replace(
        v,
        st=_W(m_spawn, SYNRECEIVED, v.st),
        lport=_W(m_spawn, dport, v.lport),
        rport=_W(m_spawn, sport, v.rport),
        rhost=_W(m_spawn, src, v.rhost),
        rcv_nxt=_W(m_spawn, 1, v.rcv_nxt),
        peer_wnd=_W(m_spawn, wnd, v.peer_wnd),
    )

    m_conn = app.mask & (v.st == CLOSED)
    v = _reset_view(v, m_conn, p)
    v = dataclasses.replace(
        v,
        st=_W(m_conn, SYNSENT, v.st),
        lport=_W(m_conn, app.lport, v.lport),
        rport=_W(m_conn, app.rport, v.rport),
        rhost=_W(m_conn, app.rhost, v.rhost),
    )
    v = view_write(v, app.mask & (app.write_bytes > 0), app.write_bytes)
    v = view_close(v, app.mask & app.close)
    delivered_open = v.delivered

    v = dataclasses.replace(v, segs_in=v.segs_in + m_act.to(i64))

    abs_seq = unwrap32(v.rcv_nxt, ev.data[:, LANE_SEQ])
    abs_ack = unwrap32(v.snd_una, ev.data[:, LANE_ACK])

    sig_closed = zb

    # RST kills the connection
    m_rst = rx_exact & f_rst & (v.st != CLOSED)
    v = dataclasses.replace(
        v,
        st=_W(m_rst, CLOSED, v.st),
        rto_expire=_W(m_rst, TIME_MAX, v.rto_expire),
    )
    sig_rst = m_rst
    live = m_act & ~m_rst

    # SYNSENT: SYN|ACK completes the active open
    m_sa = live & (v.st == SYNSENT) & f_syn & f_ack & (abs_ack >= 1)
    v = dataclasses.replace(
        v,
        st=_W(m_sa, ESTABLISHED, v.st),
        rcv_nxt=_W(m_sa, 1, v.rcv_nxt),
        snd_una=_W(m_sa, 1, v.snd_una),
        peer_wnd=_W(m_sa, wnd, v.peer_wnd),
        rto_expire=_W(m_sa, TIME_MAX, v.rto_expire),
        backoff=_W(m_sa, 0, v.backoff),
    )
    v = _rtt_update(v, m_sa & v.rtt_pending, now - v.rtt_ts, p)
    sig_est = m_sa
    need_ack = m_sa

    # SYNRECEIVED: the handshake-completing ACK
    m_sr = live & (v.st == SYNRECEIVED) & f_ack & ~f_syn & (abs_ack >= 1)
    v = dataclasses.replace(
        v,
        st=_W(m_sr, ESTABLISHED, v.st),
        snd_una=_W(m_sr, torch.clamp(v.snd_una, min=1), v.snd_una),
        peer_wnd=_W(m_sr, wnd, v.peer_wnd),
        rto_expire=_W(m_sr, TIME_MAX, v.rto_expire),
        backoff=_W(m_sr, 0, v.backoff),
    )
    v = _rtt_update(v, m_sr & v.rtt_pending, now - v.rtt_ts, p)
    sig_est = sig_est | m_sr

    datast = (
        (v.st == ESTABLISHED) | (v.st == FINWAIT1) | (v.st == FINWAIT2)
        | (v.st == CLOSING) | (v.st == TIMEWAIT) | (v.st == CLOSEWAIT)
        | (v.st == LASTACK)
    )
    m_data_st = live & datast

    # ---- ACK processing ----
    m_ackp = m_data_st & f_ack
    snd_una_pre = v.snd_una
    valid_ack = m_ackp & (abs_ack > v.snd_una) & (abs_ack <= v.snd_max)
    acked = _W(valid_ack, abs_ack - v.snd_una, 0)

    m_rtt = valid_ack & v.rtt_pending & (abs_ack >= v.rtt_seq)
    v = _rtt_update(v, m_rtt, now - v.rtt_ts, p)

    full_ack = valid_ack & v.in_rec & (abs_ack >= v.recover)
    part_ack = valid_ack & v.in_rec & ~full_ack
    ss = valid_ack & ~v.in_rec & (v.cwnd < v.ssthresh)
    ca = valid_ack & ~v.in_rec & ~ss
    cwnd1 = _W(ss, v.cwnd + torch.clamp(acked, max=mss), v.cwnd)
    cwnd1 = _W(ca, cwnd1 + torch.clamp((mss * mss) // torch.clamp(cwnd1, min=1), min=1), cwnd1)
    cwnd1 = _W(full_ack, v.ssthresh, cwnd1)
    cwnd1 = _W(part_ack, torch.clamp(cwnd1 - acked + mss, min=mss), cwnd1)
    rtx_hole = part_ack

    v = dataclasses.replace(
        v,
        snd_una=_W(valid_ack, abs_ack, v.snd_una),
        snd_nxt=_W(valid_ack, torch.maximum(v.snd_nxt, abs_ack), v.snd_nxt),
        cwnd=cwnd1,
        in_rec=_W(full_ack, False, v.in_rec),
        dupacks=_W(valid_ack, 0, v.dupacks),
        backoff=_W(valid_ack, 0, v.backoff),
        peer_wnd=_W(m_ackp, wnd, v.peer_wnd),
    )
    outstanding = v.snd_una < v.snd_max
    v = dataclasses.replace(
        v,
        rto_expire=_W(
            valid_ack, _W(outstanding, now + v.rto, TIME_MAX), v.rto_expire
        ),
    )

    # ---- SACK scoreboard update ----
    if p.use_sack:
        sack_s_w = ev.data[:, LANE_SACK_S]
        sack_e_w = ev.data[:, LANE_SACK_E]
        has_sack = m_ackp & (sack_s_w != sack_e_w)
        abs_ss = unwrap32(v.snd_una, sack_s_w)
        abs_se = unwrap32(v.snd_una, sack_e_w)
        sacked1 = _ooo_insert(v.sacked, has_sack, abs_ss, abs_se)
        drop = m_ackp[:, None] & (sacked1[:, :, 0] >= 0) & (
            sacked1[:, :, 1] <= v.snd_una[:, None]
        )
        v = dataclasses.replace(v, sacked=_W(drop[:, :, None], -1, sacked1))

    # duplicate ACKs -> fast retransmit at 3
    dup = (
        m_ackp & ~valid_ack & (abs_ack == snd_una_pre) & (plen == 0) & ~f_fin & outstanding
    )
    dup3 = dup & (v.dupacks == 2) & ~v.in_rec
    flight = v.snd_max - v.snd_una
    half = torch.clamp(flight // 2, min=2 * mss)
    v = dataclasses.replace(
        v,
        dupacks=_W(dup, v.dupacks + 1, v.dupacks),
        ssthresh=_W(dup3, half, v.ssthresh),
        cwnd=_W(dup3, half + 3 * mss, _W(dup & v.in_rec, v.cwnd + mss, v.cwnd)),
        recover=_W(dup3, v.snd_max, v.recover),
        in_rec=_W(dup3, True, v.in_rec),
    )
    if p.use_sack:
        hole_rx = _first_unsacked(v.snd_una, v.sacked, p.ooo_ranges)
        sack_any = (v.sacked[:, :, 0] >= 0).any(dim=1)
        march = (
            dup & v.in_rec & sack_any & (hole_rx > v.rtx_mark) & (hole_rx < v.snd_max)
        )
        rtx_hole = rtx_hole | dup3 | march
        v = dataclasses.replace(
            v, rtx_mark=_W(full_ack, 0, _W(rtx_hole, hole_rx, v.rtx_mark))
        )
    else:
        rtx_hole = rtx_hole | dup3

    # our FIN acked?
    fin_acked = m_ackp & v.fin_sent & (v.snd_una >= v.snd_end + 1)
    v = dataclasses.replace(
        v,
        st=_W(
            fin_acked & (v.st == FINWAIT1),
            FINWAIT2,
            _W(
                fin_acked & (v.st == CLOSING),
                TIMEWAIT,
                _W(fin_acked & (v.st == LASTACK), CLOSED, v.st),
            ),
        ),
    )
    sig_closed = sig_closed | (fin_acked & (v.st == CLOSED))
    enter_tw_ack = fin_acked & (v.st == TIMEWAIT)

    # ---- in-window data ----
    m_seg = m_data_st & (plen > 0)
    seg_s, seg_e = abs_seq, abs_seq + plen.to(i64)
    acceptable = m_seg & (seg_e > v.rcv_nxt) & (seg_s <= v.rcv_nxt + p.rcv_wnd)
    in_order = acceptable & (seg_s <= v.rcv_nxt)
    ooo_seg = acceptable & ~in_order
    old_rcv = v.rcv_nxt
    rcv1 = _W(in_order, seg_e, v.rcv_nxt)
    rcv1, ooo1 = _ooo_absorb(rcv1, v.ooo, in_order)
    ooo1 = _ooo_insert(ooo1, ooo_seg, seg_s, seg_e)
    v = dataclasses.replace(
        v, rcv_nxt=rcv1, ooo=ooo1, delivered=v.delivered + _W(m_seg, rcv1 - old_rcv, 0)
    )
    need_ack = need_ack | m_seg

    # ---- peer FIN ----
    m_finp = m_data_st & f_fin
    v = dataclasses.replace(
        v, rcv_fin=_W(m_finp & (v.rcv_fin < 0), seg_e, v.rcv_fin)
    )
    fin_now = m_data_st & (v.rcv_fin >= 0) & (v.rcv_nxt == v.rcv_fin)
    v = dataclasses.replace(v, rcv_nxt=_W(fin_now, v.rcv_nxt + 1, v.rcv_nxt))
    st_after_fin = _W(
        fin_now & (v.st == ESTABLISHED),
        CLOSEWAIT,
        _W(
            fin_now & (v.st == FINWAIT2),
            TIMEWAIT,
            _W(fin_now & (v.st == FINWAIT1), CLOSING, v.st),
        ),
    )
    enter_tw_fin = fin_now & (st_after_fin == TIMEWAIT) & (v.st != TIMEWAIT)
    v = dataclasses.replace(v, st=st_after_fin)
    sig_fin = fin_now
    need_ack = need_ack | m_finp

    enter_tw = enter_tw_ack | enter_tw_fin
    v = dataclasses.replace(
        v, rto_expire=_W(enter_tw, now + p.timewait_ns, v.rto_expire)
    )

    # --- RST for unmatched segments ---
    m_stray = m_rx & ~rx_match & ~f_rst
    rst_data = _mk_seg(
        dport,
        sport,
        unwrap32(torch.zeros_like(abs_seq), ev.data[:, LANE_ACK]),
        abs_seq + plen.to(i64) + f_syn.to(i64) + f_fin.to(i64),
        torch.full((h,), FLAG_RST | FLAG_ACK, dtype=i32, device=dev),
        torch.zeros((h,), dtype=i32, device=dev),
        torch.zeros((h,), dtype=i64, device=dev),
    )

    # ---------------- TIMER events ----------------
    v = dataclasses.replace(
        v, tev_time=_W(m_tmr & (now >= v.tev_time), TIME_MAX, v.tev_time)
    )
    fired = m_tmr & (now >= v.rto_expire) & (v.rto_expire < TIME_MAX)
    tw_done = fired & (v.st == TIMEWAIT)
    v = dataclasses.replace(
        v,
        st=_W(tw_done, CLOSED, v.st),
        rto_expire=_W(tw_done, TIME_MAX, v.rto_expire),
    )
    sig_closed = sig_closed | tw_done

    rto_fire = fired & ~tw_done & (v.snd_una < v.snd_max)
    flight_w = v.snd_max - v.snd_una
    v = dataclasses.replace(
        v,
        ssthresh=_W(rto_fire, torch.clamp(flight_w // 2, min=2 * mss), v.ssthresh),
        cwnd=_W(rto_fire, mss, v.cwnd),
        snd_nxt=_W(rto_fire, v.snd_una, v.snd_nxt),
        in_rec=_W(rto_fire, False, v.in_rec),
        dupacks=_W(rto_fire, 0, v.dupacks),
        rto=_W(rto_fire, torch.clamp(v.rto * 2, max=p.rto_max_ns), v.rto),
        backoff=_W(rto_fire, v.backoff + 1, v.backoff),
        rtt_pending=_W(rto_fire, False, v.rtt_pending),
        rto_expire=_W(rto_fire, TIME_MAX, v.rto_expire),
        sacked=_W(rto_fire[:, None, None], -1, v.sacked),
        rtx_mark=_W(rto_fire, 0, v.rtx_mark),
    )

    # ---------------- OUTPUT (the send engine) ----------------
    out_slot = focus
    out_mask = m_act | m_tmr | m_flush | app.mask
    rtx_hole = rtx_hole & m_act
    o = v

    m_syn_out = out_mask & ((o.st == SYNSENT) | (o.st == SYNRECEIVED)) & (o.snd_nxt == 0)
    syn_flags = _W(o.st == SYNRECEIVED, FLAG_SYN | FLAG_ACK, FLAG_SYN).to(i32)
    syn_is_rtx = m_syn_out & (o.snd_max > 0)
    can_send = out_mask & (
        (o.st == ESTABLISHED) | (o.st == CLOSEWAIT) | (o.st == FINWAIT1)
        | (o.st == CLOSING) | (o.st == LASTACK)
    )
    wnd_lim = o.snd_una + torch.minimum(o.cwnd, o.peer_wnd)
    fin_lim = o.snd_end + o.fin_pending.to(i64)

    hole = o.snd_una
    if p.use_sack:
        hole = _first_unsacked(hole, o.sacked, p.ooo_ranges)
    cursor = _W(rtx_hole & can_send, hole, o.snd_nxt)
    is_first_rtx = rtx_hole & can_send

    new_rtt_pending = o.rtt_pending & ~is_first_rtx
    new_rtt_seq = o.rtt_seq
    new_rtt_ts = o.rtt_ts
    sent_any = zb
    nseg = p.segs_per_flush
    fin_goes = zb
    rtx_count = torch.zeros((h,), dtype=i64, device=dev)
    wnd_col = torch.full((h,), p.rcv_wnd, dtype=i64, device=dev)
    pv, pdst, pdata, psz = [], [], [], []

    for i in range(nseg):
        room = torch.minimum(torch.minimum(o.snd_end, wnd_lim), cursor + mss)
        dlen = torch.clamp(room - cursor, min=0)
        send_data = can_send & (dlen > 0)
        send_fin = (
            can_send & ~send_data & o.fin_pending & (cursor == o.snd_end)
            & (cursor + 1 <= wnd_lim) & ~fin_goes
        )
        lane_used = send_data | send_fin
        seq_w = cursor
        lflags = _W(send_fin, FLAG_FIN | FLAG_ACK, _W(send_data, FLAG_ACK, 0)).to(i32)
        if i == 0:
            lane_used = lane_used | m_syn_out
            seq_w = _W(m_syn_out, 0, cursor)
            lflags = _W(m_syn_out, syn_flags, lflags)
        lplen = _W(send_data, dlen, 0).to(i32)
        seg = _mk_seg(o.lport, o.rport, seq_w, o.rcv_nxt, lflags, lplen, wnd_col)
        pv.append(lane_used)
        pdst.append(o.rhost)
        pdata.append(seg)
        psz.append(lplen + p.header_bytes)

        is_rtx = send_data & (cursor < o.snd_max)
        if i == 0:
            is_rtx = is_rtx | is_first_rtx | syn_is_rtx
        rtx_count = rtx_count + is_rtx.to(i64)
        fresh = send_data & (cursor >= o.snd_max) & ~is_rtx
        start_rtt = fresh & ~new_rtt_pending
        new_rtt_pending = new_rtt_pending | start_rtt
        new_rtt_seq = _W(start_rtt, cursor + dlen, new_rtt_seq)
        new_rtt_ts = _W(start_rtt, now, new_rtt_ts)

        cursor = cursor + _W(send_data, dlen, 0) + send_fin.to(i64)
        if i == 0:
            cursor = _W(is_first_rtx, torch.maximum(cursor, o.snd_nxt), cursor)
        fin_goes = fin_goes | send_fin
        sent_any = sent_any | lane_used

    syn_adv = m_syn_out
    new_nxt = _W(can_send, torch.maximum(o.snd_nxt, cursor), o.snd_nxt)
    new_nxt = _W(syn_adv, 1, new_nxt)
    new_max = torch.maximum(o.snd_max, new_nxt)
    st1 = _W(
        fin_goes & (o.st == ESTABLISHED),
        FINWAIT1,
        _W(fin_goes & (o.st == CLOSEWAIT), LASTACK, o.st),
    )
    syn_rtt = syn_adv & ~new_rtt_pending & ~syn_is_rtx
    new_rtt_pending = new_rtt_pending | syn_rtt
    new_rtt_seq = _W(syn_rtt, 1, new_rtt_seq)
    new_rtt_ts = _W(syn_rtt, now, new_rtt_ts)

    outstanding_o = (o.snd_una < new_max) | m_syn_out
    arm = out_mask & outstanding_o & (o.rto_expire >= TIME_MAX) & (sent_any | m_syn_out)
    new_expire = _W(arm, now + o.rto, o.rto_expire)
    more = can_send & (torch.minimum(fin_lim, wnd_lim) > cursor)
    need_tev = out_mask & (new_expire < o.tev_time)
    new_tev = _W(need_tev, new_expire, o.tev_time)

    segs_out_add = torch.stack(pv, dim=1).sum(dim=1)
    v = dataclasses.replace(
        o,
        snd_nxt=new_nxt,
        snd_max=new_max,
        st=st1,
        fin_sent=o.fin_sent | fin_goes,
        rtt_pending=new_rtt_pending,
        rtt_seq=new_rtt_seq,
        rtt_ts=new_rtt_ts,
        rto_expire=new_expire,
        tev_time=new_tev,
        retransmits=o.retransmits + rtx_count,
        segs_out=o.segs_out + segs_out_add,
    )

    # ---------------- control lane: ACK / RST ----------------
    if p.use_sack:
        sack_s, sack_e = lowest_ooo_block(v.ooo)
    else:
        sack_s = sack_e = torch.zeros((h,), dtype=i64, device=dev)
    ack_data = _mk_seg(
        v.lport, v.rport, v.snd_nxt, v.rcv_nxt,
        torch.full((h,), FLAG_ACK, dtype=i32, device=dev),
        torch.zeros((h,), dtype=i32, device=dev),
        wnd_col, sack_s=sack_s, sack_e=sack_e,
    )
    ctrl_valid = (need_ack & m_act) | m_stray
    pv.append(ctrl_valid)
    pdst.append(_W(m_stray, src, v.rhost))
    pdata.append(_W(m_stray[:, None], rst_data, ack_data))
    psz.append(torch.full((h,), p.header_bytes, dtype=i32, device=dev))

    zl = torch.zeros((h,), dtype=i32, device=dev)
    l_data0 = torch.zeros((h, PAYLOAD_LANES), dtype=i32, device=dev)
    l_data0[:, 0] = out_slot
    emits = TcpEmits(
        p_valid=torch.stack(pv, dim=1),
        p_dst=torch.stack(pdst, dim=1),
        p_data=torch.stack(pdata, dim=1),
        p_size=torch.stack(psz, dim=1),
        l_valid=torch.stack([more, need_tev], dim=1),
        l_time=torch.stack([now, _W(need_tev, new_expire, now)], dim=1),
        l_kind=torch.stack([zl + KIND_TCP_FLUSH, zl + KIND_TCP_TIMER], dim=1),
        l_data=torch.stack([l_data0, l_data0], dim=1),
    )
    sig = TcpSignals(
        slot=_W(out_mask, out_slot, -1).to(i32),
        established=sig_est,
        fin_seen=sig_fin,
        closed=sig_closed,
        reset=sig_rst,
    )
    return focus, out_mask, v, emits, sig, delivered_open


def lowest_ooo_block(ooo):
    """(start, end) of the lowest buffered out-of-order range, (0, 0) if
    none — the one SACK block every ACK advertises."""
    starts = ooo[:, :, 0]
    present = starts >= 0
    min_start = _W(present, starts, 1 << 62).amin(dim=1)
    at_min = present & (starts == min_start[:, None])
    blk_e = _W(at_min, ooo[:, :, 1], -1).amax(dim=1)
    has_blk = present.any(dim=1)
    return _W(has_blk, min_start, 0), _W(has_blk, blk_e, 0)
