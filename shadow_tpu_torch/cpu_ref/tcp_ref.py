"""Scalar conformance core for the device TCP path (port of
shadow_tpu/cpu_ref/tcp_ref.py): the engine window
loop + netstack ingress/egress + the vectorized TCP state machine of
transport/tcp.py, written as plain Python ints to the same specification,
with the *application* wrapper (bulk, tgen, ...) supplied by subclass
hooks. A conforming device engine must match bit-for-bit — final TCP
state, counters, and leftover queue contents (reference analogue: the
determinism suite's independent-run diffs,
src/test/determinism/CMakeLists.txt:1-40).

Subclasses implement:
  * ``LOCAL_LANES`` — total local-event lanes (2 TCP lanes + app lanes),
  * ``app_pre(host, t, kind, data)`` → ``(app_mask, app_slot)`` — the
    pre-TCP application action (connects/writes on model events),
  * ``app_post(host, t, kind, data, ctx)`` — the post-TCP application
    action (responses, closes, counters, extra local lanes via
    ``ctx.l_lanes[2:]``).

Loss draws use the same threefry stream positions as the engine (one per
packet lane, stride lanes-per-event); bucket/AQM math comes from
cpu_ref/netstack_ref.py (independently derived from the reference spec,
not from the engine's closed forms).
"""

from __future__ import annotations

import heapq
from types import SimpleNamespace

import numpy as np

from shadow_tpu_torch import rng
from shadow_tpu_torch.cpu_ref.netstack_ref import CoDelRef, TokenBucketRef
from shadow_tpu_torch.cpu_ref.sim import draw_counter, host_array
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.equeue import PAYLOAD_LANES
from shadow_tpu_torch.events import KIND_PACKET, pack_tie, tie_src_host
from shadow_tpu_torch.netstack import AUX_SHAPED_BIT, AUX_SIZE_MASK
from shadow_tpu_torch.simtime import TIME_MAX
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
)
from shadow_tpu_torch.transport.tcp import (
    CLOSED,
    CLOSEWAIT,
    CLOSING,
    ESTABLISHED,
    FINWAIT1,
    FINWAIT2,
    KIND_TCP_FLUSH,
    KIND_TCP_TIMER,
    LASTACK,
    LISTEN,
    SYNRECEIVED,
    SYNSENT,
    TIMEWAIT,
)


def _unwrap32(near: int, wire: int) -> int:
    wire_u = wire & 0xFFFFFFFF
    delta = ((wire_u - (near & 0xFFFFFFFF) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return near + delta


def _to_wire32(seq: int) -> int:
    v = seq & 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v  # as the i32 lane stores it


class Slot:
    """One connection slot — the scalar twin of a TcpState [h, s] row."""

    __slots__ = (
        "st", "lport", "rport", "rhost", "snd_una", "snd_nxt", "snd_max",
        "snd_end", "fin_pending", "fin_sent", "peer_wnd", "rcv_nxt",
        "rcv_fin", "delivered", "ooo", "sacked", "rtx_mark", "cwnd", "ssthresh",
        "dupacks", "recover", "in_rec", "srtt", "rttvar", "rto",
        "rtt_pending", "rtt_seq", "rtt_ts", "rto_expire", "backoff",
        "tev_time", "retransmits", "segs_in", "segs_out",
    )

    def __init__(self, p):
        self.st = CLOSED
        self.lport = 0
        self.rport = 0
        self.rhost = -1
        self.reset(p)
        self.tev_time = TIME_MAX
        self.retransmits = 0
        self.segs_in = 0
        self.segs_out = 0

    def reset(self, p):
        self.snd_una = 0
        self.snd_nxt = 0
        self.snd_max = 0
        self.snd_end = 1
        self.fin_pending = False
        self.fin_sent = False
        self.peer_wnd = p.rcv_wnd
        self.rcv_nxt = 0
        self.rcv_fin = -1
        self.delivered = 0
        self.ooo = [[-1, -1] for _ in range(p.ooo_ranges)]
        self.sacked = [[-1, -1] for _ in range(p.ooo_ranges)]
        self.rtx_mark = 0
        self.cwnd = p.init_cwnd_segs * p.mss
        self.ssthresh = 1 << 40
        self.dupacks = 0
        self.recover = 0
        self.in_rec = False
        self.srtt = -1
        self.rttvar = 0
        self.rto = p.rto_init_ns
        self.rtt_pending = False
        self.rtt_seq = 0
        self.rtt_ts = 0
        self.rto_expire = TIME_MAX
        self.backoff = 0

    # --- app-side operations (the scalar twins of transport/tcp.py's) ----
    def app_connect(self, p, lport, rhost, rport):
        """tcp.connect: active open only from CLOSED (SYN goes out on the
        next output pass)."""
        if self.st == CLOSED:
            self.reset(p)
            self.st = SYNSENT
            self.lport = lport
            self.rport = rport
            self.rhost = rhost

    def app_write(self, nbytes):
        """tcp.app_write: queue byte counts unless closed/listening/FINed."""
        if self.st not in (CLOSED, LISTEN) and not self.fin_pending:
            self.snd_end += nbytes

    def app_close(self):
        """tcp.app_close: half-close — FIN after all queued data."""
        if self.st not in (CLOSED, LISTEN):
            self.fin_pending = True

    def rtt_update(self, rtt, p):
        if self.srtt < 0:
            self.rttvar = rtt // 2
            self.srtt = rtt
        else:
            self.rttvar = (3 * self.rttvar + abs(self.srtt - rtt)) // 4
            self.srtt = (7 * self.srtt + rtt) // 8
        self.rto = min(
            max(self.srtt + max(p.granularity_ns, 4 * self.rttvar), p.rto_min_ns),
            p.rto_max_ns,
        )
        self.rtt_pending = False

    def ooo_absorb(self):
        """_ooo_absorb: R passes of reach-extension over buffered ranges."""
        for _ in range(len(self.ooo)):
            reach = -1
            hits = []
            for i, (s, e) in enumerate(self.ooo):
                if s >= 0 and s <= self.rcv_nxt:
                    hits.append(i)
                    reach = max(reach, e)
            self.rcv_nxt = max(self.rcv_nxt, reach)
            for i in hits:
                self.ooo[i] = [-1, -1]

    @staticmethod
    def _range_insert(ranges, s, e):
        """_ooo_insert: merge all overlapping ranges with [s, e); place the
        merged range in the first overlapping-or-empty slot; silently drop
        when the set is full and disjoint (exactly the vector semantics)."""
        ms, me = s, e
        overlap = []
        for i, (rs, re) in enumerate(ranges):
            if rs >= 0 and s <= re and e >= rs:
                overlap.append(i)
                ms = min(ms, rs)
                me = max(me, re)
        ins = None
        for i, (rs, re) in enumerate(ranges):
            if i in overlap or rs < 0:
                ins = i
                break
        for i in overlap:
            ranges[i] = [-1, -1]
        if ins is not None:
            ranges[ins] = [ms, me]

    def ooo_insert(self, s, e):
        self._range_insert(self.ooo, s, e)


class CpuRefTcpBase:
    """Scalar oracle engine: window loop + netstack + TCP, app via hooks."""

    LOCAL_LANES = 3  # tcp flush + tcp timer + one app lane (override)

    def __init__(self, cfg: EngineConfig, tcp_params, tables, host_node,
                 tx_bytes_per_interval=None, rx_bytes_per_interval=None):
        self.cfg = cfg
        self.p = tcp_params
        self.h = cfg.num_hosts
        self.keys = rng.host_keys(cfg.seed, self.h)
        self.lat = host_array(tables.lat_ns)
        self.rel = host_array(tables.rel)
        self.node = [int(x) for x in host_node]
        self.queues = [[] for _ in range(self.h)]  # (time, tie, kind, data, aux)
        self.seq = [0] * self.h
        self.ctr = [0] * self.h
        self.packets_sent = [0] * self.h
        self.packets_dropped = [0] * self.h
        self.events_handled = [0] * self.h
        self.trace = []

        self.slots = [[Slot(self.p) for _ in range(self.p.num_sockets)] for _ in range(self.h)]

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

    # --- app hooks (override) --------------------------------------------
    def app_pre(self, host, t, kind, data):
        """Pre-TCP application action; returns (app_mask, app_slot)."""
        return False, 0

    def app_post(self, host, t, kind, data, ctx):
        """Post-TCP application action; may mutate slots/ctx.l_lanes."""

    # --- threefry draws (identical stream positions) ---------------------
    def _u_f32(self, host, counter) -> float:
        return float(
            rng.uniform_f32(self.keys[host : host + 1], draw_counter(counter))[0]
        )

    # --- engine ingress (identical semantics to handle_one_iteration) ----
    def _ingress(self, host, t, tie, kind, data, aux) -> bool:
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
            src == host or t < self.cfg.bootstrap_end_ns or self.rx_tb[host].refill <= 0
        )
        if exempt:
            self.bytes_recv[host] += size
            return True
        tb = self.rx_tb[host]
        tok0, last0 = tb.tokens, tb.last
        ready = tb.depart(t, size)
        sojourn = ready - t
        if self.codel[host].dequeue(ready, sojourn, self.rx_backlog[host]):
            tb.tokens, tb.last = tok0, last0
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

    # --- the scalar tcp_handle -------------------------------------------
    def _handle(self, host, t, tie, kind, data, aux, window_end, outbox):
        p = self.p
        self.trace.append((t, tie, kind, data, host))
        if not self._ingress(host, t, tie, kind, data, aux):
            # deferred/AQM-dropped arrivals never reach the model: neither
            # the event counter nor the draw stride advances (the engine
            # clears ev.valid before both updates)
            return
        self.events_handled[host] += 1
        slots = self.slots[host]

        app_mask, app_slot = self.app_pre(host, t, kind, data)
        # after app_pre: a connect on a recycled slot resets `delivered`,
        # and the device model sums delivered only after its connect call
        bytes_before = sum(s.delivered for s in slots)

        l_lanes = [None] * self.LOCAL_LANES
        p_lanes = [None] * p.packet_lanes

        m_rx = kind == KIND_PACKET
        m_tmr = kind == KIND_TCP_TIMER
        m_flush = kind == KIND_TCP_FLUSH

        sig_est = sig_fin = sig_closed = sig_rst = False
        need_ack = False
        rtx_hole = False
        m_act = False
        m_stray = False
        act = None
        act_i = 0
        stray_rst = None
        src = int(tie_src_host(tie))

        if m_rx:
            sport, dport = (data[LANE_PORTS] >> 16) & 0xFFFF, data[LANE_PORTS] & 0xFFFF
            flags = data[LANE_FLAGS_LEN] & 0xFF
            plen = (data[LANE_FLAGS_LEN] >> 8) & 0xFFFFFF
            wnd = data[LANE_WND]
            f_syn = bool(flags & FLAG_SYN)
            f_ack = bool(flags & FLAG_ACK)
            f_fin = bool(flags & FLAG_FIN)
            f_rst = bool(flags & FLAG_RST)

            rx_exact_i = rx_lsn_i = None
            for i, s in enumerate(slots):
                if (
                    rx_exact_i is None
                    and s.st not in (CLOSED, LISTEN)
                    and s.lport == dport
                    and s.rhost == src
                    and s.rport == sport
                ):
                    rx_exact_i = i
                if rx_lsn_i is None and s.st == LISTEN and s.lport == dport:
                    rx_lsn_i = i
            rx_listen = rx_exact_i is None and rx_lsn_i is not None
            rx_match = rx_exact_i is not None or rx_lsn_i is not None

            # passive open: SYN to a listener spawns a child slot
            m_spawn = False
            if rx_listen and f_syn and not f_ack:
                child_i = next((i for i, s in enumerate(slots) if s.st == CLOSED), None)
                if child_i is not None:
                    m_spawn = True
                    cs = slots[child_i]
                    cs.reset(p)
                    cs.st = SYNRECEIVED
                    cs.lport = dport
                    cs.rport = sport
                    cs.rhost = src
                    cs.rcv_nxt = 1
                    cs.peer_wnd = wnd
                    act, act_i = cs, child_i

            if rx_exact_i is not None:
                act, act_i = slots[rx_exact_i], rx_exact_i
            m_act = (rx_exact_i is not None) or m_spawn
            if m_act:
                v = act
                v.segs_in += 1
                abs_seq = _unwrap32(v.rcv_nxt, data[LANE_SEQ])
                abs_ack = _unwrap32(v.snd_una, data[LANE_ACK])

                m_rst = f_rst and v.st != CLOSED
                if m_rst:
                    v.st = CLOSED
                    v.rto_expire = TIME_MAX
                    sig_rst = True
                live = not m_rst

                # SYNSENT: SYN|ACK completes the active open
                if live and v.st == SYNSENT and f_syn and f_ack and abs_ack >= 1:
                    v.st = ESTABLISHED
                    v.rcv_nxt = 1
                    v.snd_una = 1
                    v.peer_wnd = wnd
                    v.rto_expire = TIME_MAX
                    v.backoff = 0
                    if v.rtt_pending:
                        v.rtt_update(t - v.rtt_ts, p)
                    sig_est = True
                    need_ack = True
                # SYNRECEIVED: handshake-completing ACK
                elif live and v.st == SYNRECEIVED and f_ack and not f_syn and abs_ack >= 1:
                    v.st = ESTABLISHED
                    v.snd_una = max(v.snd_una, 1)
                    v.peer_wnd = wnd
                    v.rto_expire = TIME_MAX
                    v.backoff = 0
                    if v.rtt_pending:
                        v.rtt_update(t - v.rtt_ts, p)
                    sig_est = True

                datast = v.st in (
                    ESTABLISHED, FINWAIT1, FINWAIT2, CLOSING, TIMEWAIT, CLOSEWAIT, LASTACK,
                )
                m_data_st = live and datast

                # ---- ACK processing ----
                m_ackp = m_data_st and f_ack
                snd_una_pre = v.snd_una
                valid_ack = m_ackp and v.snd_una < abs_ack <= v.snd_max
                acked = abs_ack - v.snd_una if valid_ack else 0
                if valid_ack and v.rtt_pending and abs_ack >= v.rtt_seq:
                    v.rtt_update(t - v.rtt_ts, p)
                full_ack = valid_ack and v.in_rec and abs_ack >= v.recover
                part_ack = valid_ack and v.in_rec and not full_ack
                ss = valid_ack and not v.in_rec and v.cwnd < v.ssthresh
                ca = valid_ack and not v.in_rec and not ss
                cwnd1 = v.cwnd + min(acked, p.mss) if ss else v.cwnd
                if ca:
                    cwnd1 = cwnd1 + max((p.mss * p.mss) // max(cwnd1, 1), 1)
                if full_ack:
                    cwnd1 = v.ssthresh
                if part_ack:
                    cwnd1 = max(cwnd1 - acked + p.mss, p.mss)
                rtx_hole = part_ack
                if valid_ack:
                    v.snd_una = abs_ack
                    v.snd_nxt = max(v.snd_nxt, abs_ack)
                    v.dupacks = 0
                    v.backoff = 0
                if full_ack:
                    v.in_rec = False
                v.cwnd = cwnd1
                if m_ackp:
                    v.peer_wnd = wnd
                outstanding = v.snd_una < v.snd_max
                if valid_ack:
                    v.rto_expire = (t + v.rto) if outstanding else TIME_MAX

                # SACK scoreboard (mirrors the vector order: insert the
                # reported block, then drop ranges covered by the
                # post-advance cumulative ACK)
                if p.use_sack:
                    ss_w, se_w = data[LANE_SACK_S], data[LANE_SACK_E]
                    if m_ackp and ss_w != se_w:
                        v._range_insert(
                            v.sacked,
                            _unwrap32(v.snd_una, ss_w),
                            _unwrap32(v.snd_una, se_w),
                        )
                    if m_ackp:
                        for i, (rs, re) in enumerate(v.sacked):
                            if rs >= 0 and re <= v.snd_una:
                                v.sacked[i] = [-1, -1]

                dup = (
                    m_ackp
                    and not valid_ack
                    and abs_ack == snd_una_pre
                    and plen == 0
                    and not f_fin
                    and outstanding
                )
                dup3 = dup and v.dupacks == 2 and not v.in_rec
                flight = v.snd_max - v.snd_una
                if dup:
                    v.dupacks += 1
                if dup3:
                    v.ssthresh = max(flight // 2, 2 * p.mss)
                    v.cwnd = v.ssthresh + 3 * p.mss
                    v.recover = v.snd_max
                    v.in_rec = True
                elif dup and v.in_rec:
                    v.cwnd += p.mss
                if p.use_sack:
                    # first unsacked hole per the tally, marched once per
                    # episode (the managed _last_rexmit marks)
                    hole_rx = v.snd_una
                    for _ in range(len(v.sacked)):
                        reach = -1
                        for rs, re in v.sacked:
                            if rs >= 0 and rs <= hole_rx < re:
                                reach = max(reach, re)
                        hole_rx = max(hole_rx, reach)
                    sack_any = any(rs >= 0 for rs, _re in v.sacked)
                    march = (
                        dup and v.in_rec and sack_any
                        and hole_rx > v.rtx_mark and hole_rx < v.snd_max
                    )
                    rtx_hole = rtx_hole or dup3 or march
                    if full_ack:
                        v.rtx_mark = 0
                    elif rtx_hole:
                        v.rtx_mark = hole_rx
                else:
                    rtx_hole = rtx_hole or dup3

                fin_acked = m_ackp and v.fin_sent and v.snd_una >= v.snd_end + 1
                if fin_acked:
                    if v.st == FINWAIT1:
                        v.st = FINWAIT2
                    elif v.st == CLOSING:
                        v.st = TIMEWAIT
                    elif v.st == LASTACK:
                        v.st = CLOSED
                sig_closed = sig_closed or (fin_acked and v.st == CLOSED)
                enter_tw_ack = fin_acked and v.st == TIMEWAIT

                # ---- in-window data ----
                m_seg = m_data_st and plen > 0
                seg_s, seg_e = abs_seq, abs_seq + plen
                acceptable = (
                    m_seg and seg_e > v.rcv_nxt and seg_s <= v.rcv_nxt + p.rcv_wnd
                )
                in_order = acceptable and seg_s <= v.rcv_nxt
                ooo_seg = acceptable and not in_order
                old_rcv = v.rcv_nxt
                if in_order:
                    v.rcv_nxt = seg_e
                    v.ooo_absorb()
                if ooo_seg:
                    v.ooo_insert(seg_s, seg_e)
                if m_seg:
                    v.delivered += v.rcv_nxt - old_rcv
                    need_ack = True

                # ---- peer FIN ----
                m_finp = m_data_st and f_fin
                if m_finp and v.rcv_fin < 0:
                    v.rcv_fin = seg_e
                fin_now = m_data_st and v.rcv_fin >= 0 and v.rcv_nxt == v.rcv_fin
                enter_tw_fin = False
                if fin_now:
                    v.rcv_nxt += 1
                    if v.st == ESTABLISHED:
                        v.st = CLOSEWAIT
                    elif v.st == FINWAIT2:
                        enter_tw_fin = True
                        v.st = TIMEWAIT
                    elif v.st == FINWAIT1:
                        v.st = CLOSING
                    sig_fin = True
                if m_finp:
                    need_ack = True
                if enter_tw_ack or enter_tw_fin:
                    v.rto_expire = t + p.timewait_ns
            elif not rx_match and not f_rst:
                # stray segment (no connection *and* no listener on the
                # port): RST. A port-matched segment that spawned nothing —
                # e.g. a SYN to a listener with a full backlog — is silently
                # dropped, exactly like the vector path's rx_match test.
                m_stray = True
                ack_for = _unwrap32(0, data[LANE_ACK])
                abs_seq0 = _unwrap32(0, data[LANE_SEQ])
                stray_rst = self._mk_seg(
                    dport, sport, ack_for,
                    abs_seq0 + plen + (1 if f_syn else 0) + (1 if f_fin else 0),
                    FLAG_RST | FLAG_ACK, 0, 0,
                )

        if m_tmr:
            t_slot = max(0, min(data[0], p.num_sockets - 1))
            w = slots[t_slot]
            if t >= w.tev_time:
                w.tev_time = TIME_MAX
            fired = t >= w.rto_expire and w.rto_expire < TIME_MAX
            if fired and w.st == TIMEWAIT:
                w.st = CLOSED
                w.rto_expire = TIME_MAX
                sig_closed = True
            elif fired and w.snd_una < w.snd_max:
                flight_w = w.snd_max - w.snd_una
                w.ssthresh = max(flight_w // 2, 2 * p.mss)
                w.cwnd = p.mss
                w.snd_nxt = w.snd_una
                w.in_rec = False
                w.dupacks = 0
                w.rto = min(w.rto * 2, p.rto_max_ns)
                w.backoff += 1
                w.rtt_pending = False
                w.rto_expire = TIME_MAX
                if p.use_sack:  # reneging safety: timeout clears the tally
                    w.sacked = [[-1, -1] for _ in range(p.ooo_ranges)]
                    w.rtx_mark = 0

        # ---------------- OUTPUT pass ------------------------------------
        if m_act:
            out_i = act_i
        elif m_tmr:
            out_i = max(0, min(data[0], p.num_sockets - 1))
        elif m_flush:
            out_i = max(0, min(data[0], p.num_sockets - 1))
        else:
            out_i = app_slot
        out_mask = m_act or m_tmr or m_flush or app_mask
        rtx_hole = rtx_hole and m_act

        if out_mask:
            o = slots[out_i]
            m_syn_out = o.st in (SYNSENT, SYNRECEIVED) and o.snd_nxt == 0
            syn_flags = (FLAG_SYN | FLAG_ACK) if o.st == SYNRECEIVED else FLAG_SYN
            syn_is_rtx = m_syn_out and o.snd_max > 0
            can_send = o.st in (ESTABLISHED, CLOSEWAIT, FINWAIT1, CLOSING, LASTACK)
            wnd_lim = o.snd_una + min(o.cwnd, o.peer_wnd)
            fin_lim = o.snd_end + (1 if o.fin_pending else 0)

            hole = o.snd_una
            if p.use_sack:
                for _ in range(len(o.sacked)):
                    reach = -1
                    for rs, re in o.sacked:
                        if rs >= 0 and rs <= hole < re:
                            reach = max(reach, re)
                    hole = max(hole, reach)
            cursor = hole if (rtx_hole and can_send) else o.snd_nxt
            is_first_rtx = rtx_hole and can_send
            if is_first_rtx:
                o.rtt_pending = False  # Karn
            sent_any = False
            fin_goes = False
            rtx_count = 0
            for i in range(p.segs_per_flush):
                room = min(o.snd_end, wnd_lim, cursor + p.mss)
                dlen = max(room - cursor, 0)
                send_data = can_send and dlen > 0
                send_fin = (
                    can_send
                    and not send_data
                    and o.fin_pending
                    and cursor == o.snd_end
                    and cursor + 1 <= wnd_lim
                    and not fin_goes
                )
                lane_used = send_data or send_fin
                seq_w = cursor
                lflags = (
                    (FLAG_FIN | FLAG_ACK) if send_fin else (FLAG_ACK if send_data else 0)
                )
                if i == 0 and m_syn_out:
                    lane_used = True
                    seq_w = 0
                    lflags = syn_flags
                lplen = dlen if send_data else 0
                if lane_used:
                    p_lanes[i] = (
                        o.rhost,
                        self._mk_seg(o.lport, o.rport, seq_w, o.rcv_nxt, lflags,
                                     lplen, p.rcv_wnd),
                        lplen + p.header_bytes,
                    )
                is_rtx = send_data and cursor < o.snd_max
                if i == 0:
                    is_rtx = is_rtx or is_first_rtx or syn_is_rtx
                rtx_count += 1 if is_rtx else 0
                fresh = send_data and cursor >= o.snd_max and not is_rtx
                if fresh and not o.rtt_pending:
                    o.rtt_pending = True
                    o.rtt_seq = cursor + dlen
                    o.rtt_ts = t
                cursor = cursor + (dlen if send_data else 0) + (1 if send_fin else 0)
                if i == 0 and is_first_rtx:
                    cursor = max(cursor, o.snd_nxt)
                fin_goes = fin_goes or send_fin
                sent_any = sent_any or lane_used

            if can_send:
                o.snd_nxt = max(o.snd_nxt, cursor)
            if m_syn_out:
                o.snd_nxt = 1
            o.snd_max = max(o.snd_max, o.snd_nxt)
            if fin_goes:
                if o.st == ESTABLISHED:
                    o.st = FINWAIT1
                elif o.st == CLOSEWAIT:
                    o.st = LASTACK
            if m_syn_out and not o.rtt_pending and not syn_is_rtx:
                o.rtt_pending = True
                o.rtt_seq = 1
                o.rtt_ts = t
            outstanding_o = (o.snd_una < o.snd_max) or m_syn_out
            if outstanding_o and o.rto_expire >= TIME_MAX and (sent_any or m_syn_out):
                o.rto_expire = t + o.rto
            more = can_send and min(fin_lim, wnd_lim) > cursor
            need_tev = o.rto_expire < o.tev_time
            if need_tev:
                o.tev_time = o.rto_expire
            if fin_goes:
                o.fin_sent = True
            o.retransmits += rtx_count
            o.segs_out += sum(1 for x in p_lanes[: p.segs_per_flush] if x is not None)

            if more:
                l_lanes[0] = (t, KIND_TCP_FLUSH, out_i)
            if need_tev:
                l_lanes[1] = (o.rto_expire, KIND_TCP_TIMER, out_i)

        # control lane (ACK / stray RST) — post-output freshness
        if m_act and need_ack:
            va = slots[act_i]
            ss = se = 0
            if p.use_sack:
                present = [(rs, re) for rs, re in va.ooo if rs >= 0]
                if present:
                    ss, se = min(present)  # lowest-start buffered range
            p_lanes[p.segs_per_flush] = (
                va.rhost,
                self._mk_seg(va.lport, va.rport, va.snd_nxt, va.rcv_nxt,
                             FLAG_ACK, 0, p.rcv_wnd, sack_s=ss, sack_e=se),
                p.header_bytes,
            )
        elif m_stray:
            p_lanes[p.segs_per_flush] = (src, stray_rst, p.header_bytes)

        # --- application wrapper (post-TCP) -------------------------------
        ctx = SimpleNamespace(
            sig_est=sig_est,
            sig_fin=sig_fin,
            sig_closed=sig_closed,
            sig_rst=sig_rst,
            out_mask=out_mask,
            out_i=out_i,
            sig_slot=out_i if out_mask else -1,
            l_lanes=l_lanes,
            bytes_before=bytes_before,
            app_mask=app_mask,
            app_slot=app_slot,
        )
        self.app_post(host, t, kind, data, ctx)

        # ------------- engine wrap: seq minting, egress, loss -------------
        base_ctr = self.ctr[host]
        # local lanes first (lane order), then surviving packets
        for lane in l_lanes:
            if lane is not None:
                lt, lk, lslot = lane
                ltie = pack_tie(lk, host, self.seq[host])
                self.seq[host] += 1
                ldata = (lslot,) + (0,) * (PAYLOAD_LANES - 1)
                heapq.heappush(self.queues[host], (lt, ltie, lk, ldata, 0))
        for pi in range(p.packet_lanes):
            lane = p_lanes[pi]
            if lane is None:
                continue
            dst, seg_data, size = lane
            dst = max(0, min(dst, self.h - 1))
            lat = int(self.lat[self.node[host], self.node[dst]])
            rel = float(self.rel[self.node[host], self.node[dst]])
            loss_u = self._u_f32(host, base_ctr + pi)
            if lat >= TIME_MAX:
                continue
            dep = t
            if self.cfg.use_netstack:
                exempt = dst == host or t < self.cfg.bootstrap_end_ns
                if not exempt:
                    dep = self.tx_tb[host].depart(t, size)
            if loss_u < rel:
                deliver = max(dep + lat, window_end)
                ptie = pack_tie(KIND_PACKET, host, self.seq[host])
                self.seq[host] += 1
                outbox.append((dst, deliver, ptie, seg_data, size & AUX_SIZE_MASK))
                self.packets_sent[host] += 1
                if self.cfg.use_netstack:
                    self.bytes_sent[host] += size
            else:
                self.packets_dropped[host] += 1
        self.ctr[host] = base_ctr + p.packet_lanes

    @staticmethod
    def _mk_seg(lport, rport, seq, ack, flags, plen, wnd, sack_s=0, sack_e=0):
        data = [0] * PAYLOAD_LANES
        # the device packs ports into an i32 lane; local ports >= 32768
        # wrap negative on the wire, so mirror the two's-complement view
        data[LANE_PORTS] = _to_wire32(((lport & 0xFFFF) << 16) | (rport & 0xFFFF))
        data[LANE_SEQ] = _to_wire32(seq)
        data[LANE_ACK] = _to_wire32(ack)
        data[LANE_FLAGS_LEN] = (flags & 0xFF) | (plen << 8)
        data[LANE_WND] = int(wnd)
        data[LANE_SACK_S] = _to_wire32(sack_s)
        data[LANE_SACK_E] = _to_wire32(sack_e)
        return tuple(data)

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
        return sorted((t, tie, kind, tuple(data)) for t, tie, kind, data, _aux in self.queues[host])

    def tcp_field(self, name) -> np.ndarray:
        """[H, S] array of one TcpState field for device comparison."""
        if name in ("ooo", "sacked"):
            return np.array(
                [[getattr(s, name) for s in row] for row in self.slots],
                dtype=np.int64,
            )
        return np.array(
            [[getattr(s, name) for s in row] for row in self.slots]
        )
