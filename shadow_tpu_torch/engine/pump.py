"""Packet-pump microscan (port of shadow_tpu/engine/pump.py): the plain
PyTorch twin of the CUDA pump megakernel.

Drains up to K consecutive pump-class events per host per iteration
through three narrowly-conditioned fast paths:

  P1  ingress defer/drop: an unshaped arrival that the rx token bucket
      defers (or CoDel drops).
  P2  data completion at a receiver (in-order or out-of-order), with one
      SACK-carrying ACK out.
  P3  cumulative ACK at a sender: snd_una advance, Reno step, RTO
      re-arm, RTT sample, scoreboard merge, and the send-engine lanes.

Anything else is rejected and taken by the full handler in the same
iteration, so the pump is a pure accelerator: the per-host event
sequence is bit-identical to running the full handler per event. Each
microstep re-selects the host's true next event by the total-order key,
comparing the queue head against a small pending-defer FIFO.

`pump_stage` is what the CPU runs for engine="megakernel"
(engine/megakernel.py), and what chip_smoke.py holds the kernel against
on the card. Every operation here is row-local, which is what lets the
kernel give each host row its own thread. On an ensemble's rows view
(engine/state.py::rows_view) the window end, `min_used_lat` and the
rejected flag are per replica: each row reads and folds into its own
replica's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from shadow_tpu_torch import equeue, netstack, rng
from shadow_tpu_torch.engine.state import EngineConfig, SimState, per_row, replicas_of
from shadow_tpu_torch.events import KIND_PACKET, pack_tie, tie_src_host
from shadow_tpu_torch.graph.routing import RoutingTables
from shadow_tpu_torch.netstack import AUX_SHAPED_BIT, AUX_SIZE_MASK
from shadow_tpu_torch.simtime import TIME_MAX
from shadow_tpu_torch.transport import tcp as T
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
    unpack_flags_len,
    unpack_ports,
    unwrap32,
)

_I64_MAX = equeue.I64_MAX
_W = torch.where


@dataclasses.dataclass(frozen=True)
class TcpPumpSpec:
    """Model-side pump contract for models embedding transport/tcp.py:
    get_tcp/set_tcp map between the model state and its TcpState; `block`
    vetoes steps where the model would react to the candidate post-event
    slot state; `apply` is the model's passive per-event bookkeeping."""

    params: T.TcpParams
    get_tcp: Callable[[Any], T.TcpState]
    set_tcp: Callable[[Any, T.TcpState], Any]
    block: Callable[..., torch.Tensor]
    apply: Callable[..., Any]


@dataclasses.dataclass
class PumpCarry:
    """Everything a pump microstep reads or writes, host-axis leading
    (min_used is the one per-world value: a scalar, or [R] on an
    ensemble's rows)."""

    q: equeue.EventQueue
    net: Any
    ts: T.TcpState
    mstate: Any
    obv: torch.Tensor
    obd: torch.Tensor
    obt: torch.Tensor
    obtie: torch.Tensor
    obdata: torch.Tensor
    obaux: torch.Tensor
    obfill: torch.Tensor
    obover: torch.Tensor
    f_time: torch.Tensor
    f_tie: torch.Tensor
    f_kind: torch.Tensor
    f_data: torch.Tensor
    f_aux: torch.Tensor
    f_head: torch.Tensor
    f_cnt: torch.Tensor
    seq: torch.Tensor
    rng_counter: torch.Tensor
    events_handled: torch.Tensor
    packets_sent: torch.Tensor
    packets_dropped: torch.Tensor
    packets_unroutable: torch.Tensor
    trk_bytes_ctrl: "torch.Tensor | None"
    trk_bytes_data: "torch.Tensor | None"
    trk_retrans: "torch.Tensor | None"
    min_used: torch.Tensor
    alive: torch.Tensor
    rejected: torch.Tensor
    host_ids: torch.Tensor
    src_node: torch.Tensor
    key_data: torch.Tensor
    codel_table: torch.Tensor


def _fifo_peek(f_time, f_tie, f_head, f_cnt):
    k = f_time.shape[1]
    oh = torch.arange(k, device=f_time.device)[None, :] == f_head[:, None]
    has = f_head < f_cnt
    t = _W(has, _W(oh, f_time, 0).sum(dim=1), TIME_MAX)
    tie = _W(has, _W(oh, f_tie, 0).sum(dim=1), _I64_MAX)
    return has, t, tie, oh


def pump_carry_init(st: SimState, model, tables: RoutingTables, cfg: EngineConfig) -> PumpCarry:
    """Build the microstep carry (the FIFO is sized cfg.pump_k)."""
    spec: TcpPumpSpec = model.pump_spec
    k = cfg.pump_k
    h = st.num_hosts
    dev = st.device
    ob = st.outbox
    return PumpCarry(
        q=st.queue,
        net=st.net,
        ts=spec.get_tcp(st.model),
        mstate=st.model,
        obv=ob.valid, obd=ob.dst, obt=ob.time, obtie=ob.tie,
        obdata=ob.data, obaux=ob.aux, obfill=ob.fill, obover=ob.overflow,
        f_time=torch.full((h, k), TIME_MAX, dtype=torch.int64, device=dev),
        f_tie=torch.full((h, k), _I64_MAX, dtype=torch.int64, device=dev),
        f_kind=torch.zeros((h, k), dtype=torch.int32, device=dev),
        f_data=torch.zeros((h, k, equeue.PAYLOAD_LANES), dtype=torch.int32, device=dev),
        f_aux=torch.zeros((h, k), dtype=torch.int32, device=dev),
        f_head=torch.zeros((h,), dtype=torch.int32, device=dev),
        f_cnt=torch.zeros((h,), dtype=torch.int32, device=dev),
        seq=st.seq,
        rng_counter=st.rng_counter,
        events_handled=st.events_handled,
        packets_sent=st.packets_sent,
        packets_dropped=st.packets_dropped,
        packets_unroutable=st.packets_unroutable,
        trk_bytes_ctrl=st.tracker.bytes_ctrl if cfg.tracker else None,
        trk_bytes_data=st.tracker.bytes_data if cfg.tracker else None,
        trk_retrans=st.tracker.retrans_segs if cfg.tracker else None,
        min_used=st.min_used_lat,
        alive=torch.ones((h,), dtype=torch.bool, device=dev),
        rejected=torch.zeros((h,), dtype=torch.bool, device=dev),
        host_ids=st.host_id,
        src_node=tables.host_node[st.host_id.to(torch.int64)],
        key_data=st.rng_key,
        codel_table=netstack.codel_table(dev),
    )


def pump_microstep(c: PumpCarry, window_end, model, tables: RoutingTables,
                   cfg: EngineConfig, debug_out: "list | None" = None) -> PumpCarry:
    """One microstep: select each live host's true next event, classify
    against P1/P2/P3, commit taken steps, mark the rest rejected.
    `window_end` is a scalar or one entry per row; `debug_out` collects
    per-step class tallies."""
    spec: TcpPumpSpec = model.pump_spec
    p = spec.params
    k = c.f_time.shape[1]
    h = c.seq.shape[0]
    dev = c.seq.device
    i64, i32 = torch.int64, torch.int32
    host_ids = c.host_ids
    mss = p.mss
    draws = model.DRAWS_PER_EVENT
    ep = model.PACKET_EMITS
    stride = model.DRAWS_PER_EVENT + ep
    nseg = p.segs_per_flush
    zb = torch.zeros((h,), dtype=torch.bool, device=dev)

    q, net, mstate, ts = c.q, c.net, c.mstate, c.ts
    o_cap = c.obv.shape[1]
    lane_idx_ob = torch.arange(o_cap, device=dev)[None, :]
    min_used = c.min_used
    obv, obd, obt, obtie = c.obv, c.obd, c.obt, c.obtie
    obdata, obaux, obfill, obover = c.obdata, c.obaux, c.obfill, c.obover
    f_time, f_tie, f_kind = c.f_time, c.f_tie, c.f_kind
    f_data, f_aux, f_head, f_cnt = c.f_data, c.f_aux, c.f_head, c.f_cnt
    alive = c.alive
    src_node = c.src_node

    # ---- select each host's true next event: queue vs defer FIFO ----
    qv, q_slot = equeue.peek_min(q, alive)
    if cfg.use_netstack:
        fh_has, fh_t, fh_tie, fh_oh = _fifo_peek(f_time, f_tie, f_head, f_cnt)
        use_f = alive & fh_has & (
            ~qv.valid | (fh_t < qv.time) | ((fh_t == qv.time) & (fh_tie < qv.tie))
        )
    else:
        use_f = zb
        fh_t = torch.full((h,), TIME_MAX, dtype=i64, device=dev)
        fh_tie = torch.full((h,), _I64_MAX, dtype=i64, device=dev)
        fh_oh = torch.zeros((h, k), dtype=torch.bool, device=dev)
    ev_valid = alive & (use_f | qv.valid)
    ev_time = _W(use_f, fh_t, qv.time)
    ev_valid = ev_valid & (ev_time < window_end)
    ev_tie = _W(use_f, fh_tie, qv.tie)
    ev_kind = _W(use_f, _W(fh_oh, f_kind, 0).sum(dim=1).to(i32), qv.kind)
    ev_data = _W(
        use_f[:, None], _W(fh_oh[:, :, None], f_data, 0).sum(dim=1).to(i32), qv.data
    )
    ev_aux = _W(use_f, _W(fh_oh, f_aux, 0).sum(dim=1).to(i32), qv.aux)
    ev_src = tie_src_host(ev_tie).to(i32)
    now = ev_time

    is_pkt = ev_valid & (ev_kind == KIND_PACKET)
    size_in = (ev_aux & AUX_SIZE_MASK).to(i64)
    shaped = (ev_aux & AUX_SHAPED_BIT) != 0
    loopback = ev_src == host_ids
    in_bootstrap = ev_time < cfg.bootstrap_end_ns

    # ---- ingress relay/CoDel (tentative; committed only where taken) ----
    if cfg.use_netstack:
        need = is_pkt & ~shaped & ~loopback & ~in_bootstrap & (net.rx_refill > 0)
        ready, rx_tok, rx_last = netstack.tb_depart(
            net.rx_tokens, net.rx_last, net.rx_refill, ev_time, size_in, need
        )
        codel_drop, net_c = netstack.codel_dequeue(
            net, ready, ready - ev_time, need, control_table=c.codel_table
        )
        keep_in = need & ~codel_drop
        defer = keep_in & (ready > ev_time)
        p1_take = is_pkt & ~shaped & (defer | codel_drop)
        arrived = is_pkt & ~(defer | codel_drop)
    else:
        need = codel_drop = defer = p1_take = zb
        ready = ev_time
        arrived = is_pkt
        net_c = net

    # ---- TCP classification on arrived packets ----
    sport, dport = unpack_ports(ev_data[:, LANE_PORTS])
    exact = (
        (ts.st != T.CLOSED)
        & (ts.st != T.LISTEN)
        & (ts.lport == dport[:, None])
        & (ts.rhost == ev_src[:, None])
        & (ts.rport == sport[:, None])
    )
    rx_exact = arrived & exact.any(dim=1)
    oh = exact & arrived[:, None]

    def rd(a):
        if a.dtype == torch.bool:
            return (oh & a).any(dim=1)
        return _W(oh, a, 0).sum(dim=1).to(a.dtype)

    def rd4(a):
        return _W(oh[:, :, None, None], a, 0).sum(dim=1).to(a.dtype)

    v_st = rd(ts.st)
    v_lport = rd(ts.lport)
    v_rport = rd(ts.rport)
    v_rhost = rd(ts.rhost)
    v_snd_una = rd(ts.snd_una)
    v_snd_nxt = rd(ts.snd_nxt)
    v_snd_max = rd(ts.snd_max)
    v_snd_end = rd(ts.snd_end)
    v_fin_pending = rd(ts.fin_pending)
    v_fin_sent = rd(ts.fin_sent)
    v_rcv_nxt = rd(ts.rcv_nxt)
    v_rcv_fin = rd(ts.rcv_fin)
    v_cwnd = rd(ts.cwnd)
    v_ssthresh = rd(ts.ssthresh)
    v_dupacks = rd(ts.dupacks)
    v_in_rec = rd(ts.in_rec)
    v_srtt = rd(ts.srtt)
    v_rttvar = rd(ts.rttvar)
    v_rto = rd(ts.rto)
    v_rtt_pending = rd(ts.rtt_pending)
    v_rtt_seq = rd(ts.rtt_seq)
    v_rtt_ts = rd(ts.rtt_ts)
    v_rto_expire = rd(ts.rto_expire)
    v_tev_time = rd(ts.tev_time)
    v_ooo = rd4(ts.ooo)
    v_sacked = rd4(ts.sacked)

    flags, plen = unpack_flags_len(ev_data[:, LANE_FLAGS_LEN])
    f_ackf = (flags & FLAG_ACK) != 0
    clean_flags = f_ackf & ((flags & (FLAG_SYN | FLAG_FIN | FLAG_RST)) == 0)
    wnd = ev_data[:, LANE_WND].to(i64)
    abs_seq = unwrap32(v_rcv_nxt, ev_data[:, LANE_SEQ])
    abs_ack = unwrap32(v_snd_una, ev_data[:, LANE_ACK])
    sack_present = ev_data[:, LANE_SACK_S] != ev_data[:, LANE_SACK_E]
    sacked_empty = (v_sacked[:, :, 0] < 0).all(dim=1)
    quiet = (
        rx_exact
        & (v_st == T.ESTABLISHED)
        & clean_flags
        & (v_rcv_fin < 0)
        & ~v_fin_sent
        & (v_rto_expire >= v_tev_time)
    )

    # P2: data at a receiver
    seg_s = abs_seq
    seg_e = abs_seq + plen.to(i64)
    p2 = (
        quiet
        & (plen > 0)
        & (seg_s <= v_rcv_nxt + p.rcv_wnd)
        & (abs_ack <= v_snd_una)
        & (v_snd_end <= v_snd_nxt)
        & ~v_in_rec
        & (v_dupacks == 0)
        & ~sack_present
        & sacked_empty
        & ~v_fin_pending
    )
    acceptable = p2 & (seg_e > v_rcv_nxt)
    in_order = acceptable & (seg_s <= v_rcv_nxt)
    ooo_seg = acceptable & ~in_order
    rcv1 = _W(in_order, seg_e, v_rcv_nxt)
    rcv1, ooo1 = T._ooo_absorb(rcv1, v_ooo, in_order)
    ooo1 = T._ooo_insert(ooo1, ooo_seg, seg_s, seg_e)
    delivered_delta = _W(p2, rcv1 - v_rcv_nxt, 0)

    # P3: pure cumulative ACK advancing snd_una, outside recovery
    p3 = quiet & (plen == 0) & ~v_in_rec & (abs_ack > v_snd_una) & (abs_ack <= v_snd_max)

    blocked = spec.block(
        mstate, host_ids, v_st, v_snd_end, rd(ts.delivered) + delivered_delta,
        delivered_delta,
    )
    p2 = p2 & ~blocked
    p3 = p3 & ~blocked

    # ---- P3 state update ----
    m_rtt = p3 & v_rtt_pending & (abs_ack >= v_rtt_seq)
    ss = p3 & (v_cwnd < v_ssthresh)
    ca = p3 & ~ss
    acked = _W(p3, abs_ack - v_snd_una, 0)
    cwnd1 = _W(ss, v_cwnd + torch.clamp(acked, max=mss), v_cwnd)
    cwnd1 = _W(ca, cwnd1 + torch.clamp((mss * mss) // torch.clamp(cwnd1, min=1), min=1), cwnd1)
    una1 = _W(p3, abs_ack, v_snd_una)
    nxt1 = _W(p3, torch.maximum(v_snd_nxt, abs_ack), v_snd_nxt)
    outstanding = una1 < v_snd_max
    expire1 = _W(p3, _W(outstanding, now + v_rto, TIME_MAX), v_rto_expire)
    rtt = now - v_rtt_ts
    first = v_srtt < 0
    rttvar1 = _W(first, rtt // 2, (3 * v_rttvar + torch.abs(v_srtt - rtt)) // 4)
    srtt1 = _W(first, rtt, (7 * v_srtt + rtt) // 8)
    rto1 = torch.clamp(
        srtt1 + torch.clamp(4 * rttvar1, min=p.granularity_ns), p.rto_min_ns, p.rto_max_ns
    )
    n_srtt = _W(m_rtt, srtt1, v_srtt)
    n_rttvar = _W(m_rtt, rttvar1, v_rttvar)
    n_rto = _W(m_rtt, rto1, v_rto)
    n_rtt_pending = _W(m_rtt, False, v_rtt_pending)

    if p.use_sack:
        has_sack = p3 & sack_present
        abs_ss = unwrap32(una1, ev_data[:, LANE_SACK_S])
        abs_se = unwrap32(una1, ev_data[:, LANE_SACK_E])
        sacked1 = T._ooo_insert(v_sacked, has_sack, abs_ss, abs_se)
        dropm = p3[:, None] & (sacked1[:, :, 0] >= 0) & (sacked1[:, :, 1] <= una1[:, None])
        sacked2 = _W(dropm[:, :, None], -1, sacked1)
    else:
        sacked2 = v_sacked

    # ---- P3 send engine ----
    peer_wnd1 = _W(p2 | p3, wnd, rd(ts.peer_wnd))
    wnd_lim = una1 + torch.minimum(cwnd1, peer_wnd1)
    fin_lim = v_snd_end + v_fin_pending.to(i64)
    cursor = nxt1
    can_send = p3
    rp, rs, rt = n_rtt_pending, v_rtt_seq, v_rtt_ts
    sent_any = fin_goes = zb
    rtx_count = torch.zeros((h,), dtype=i64, device=dev)
    lane_valid, lane_seq_w, lane_len, lane_fin = [], [], [], []
    for _i in range(nseg):
        room = torch.minimum(torch.minimum(v_snd_end, wnd_lim), cursor + mss)
        dlen = torch.clamp(room - cursor, min=0)
        send_data = can_send & (dlen > 0)
        send_fin = (
            can_send & ~send_data & v_fin_pending & (cursor == v_snd_end)
            & (cursor + 1 <= wnd_lim) & ~fin_goes
        )
        lane_valid.append(send_data | send_fin)
        lane_seq_w.append(cursor)
        lane_len.append(_W(send_data, dlen, 0).to(i32))
        lane_fin.append(send_fin)
        rtx_count = rtx_count + (send_data & (cursor < v_snd_max)).to(i64)
        start_rtt = send_data & (cursor >= v_snd_max) & ~rp
        rp = rp | start_rtt
        rs = _W(start_rtt, cursor + dlen, rs)
        rt = _W(start_rtt, now, rt)
        cursor = cursor + _W(send_data, dlen, 0) + send_fin.to(i64)
        fin_goes = fin_goes | send_fin
        sent_any = sent_any | send_data | send_fin
    new_nxt = _W(can_send, torch.maximum(nxt1, cursor), nxt1)
    new_max = torch.maximum(v_snd_max, new_nxt)
    arm = p3 & (una1 < new_max) & (expire1 >= TIME_MAX) & sent_any
    new_expire = _W(arm, now + n_rto, expire1)
    more = can_send & (torch.minimum(fin_lim, wnd_lim) > cursor)
    need_tev = (p2 | p3) & (new_expire < v_tev_time)
    p3 = p3 & ~more & ~need_tev
    p2 = p2 & ~need_tev

    take_tcp = p2 | p3
    take = p1_take | take_tcp
    rejected = c.rejected | (ev_valid & ~take)
    if debug_out is not None:
        debug_out.append(
            {
                name: int(val.sum())
                for name, val in dict(
                    ev_valid=ev_valid, ev_queue=ev_valid & ~use_f, p1=p1_take, p2=p2,
                    p3=p3, take=take, use_f=use_f, rejected=ev_valid & ~take,
                ).items()
            }
        )
    q = equeue.clear_slot(q, q_slot, take & ~use_f)
    f_head = f_head + (take & use_f).to(i32)

    # ---- commit netstack state ----
    if cfg.use_netstack:
        commit_n = take & need
        net = dataclasses.replace(
            net,
            rx_tokens=_W(commit_n & keep_in, rx_tok, net.rx_tokens),
            rx_last=_W(commit_n & keep_in, rx_last, net.rx_last),
            codel_first_above=_W(commit_n, net_c.codel_first_above, net.codel_first_above),
            codel_drop_next=_W(commit_n, net_c.codel_drop_next, net.codel_drop_next),
            codel_count=_W(commit_n, net_c.codel_count, net.codel_count),
            codel_dropping=_W(commit_n, net_c.codel_dropping, net.codel_dropping),
            codel_dropped=net.codel_dropped + (commit_n & codel_drop).to(i64),
            rx_backlog_bytes=net.rx_backlog_bytes
            + _W(take & defer, size_in, 0)
            - _W(take_tcp & shaped, size_in, 0),
            bytes_recv=net.bytes_recv + _W(take_tcp, size_in, 0),
        )
        ins = take & defer
        ins_oh = (torch.arange(k, device=dev)[None, :] == f_cnt[:, None]) & ins[:, None]
        f_time = _W(ins_oh, ready[:, None], f_time)
        f_tie = _W(ins_oh, ev_tie[:, None], f_tie)
        f_kind = _W(ins_oh, ev_kind[:, None], f_kind)
        f_data = _W(ins_oh[:, :, None], ev_data[:, None, :], f_data)
        f_aux = _W(
            ins_oh, (size_in.to(i32) | AUX_SHAPED_BIT)[:, None], f_aux
        )
        f_cnt = f_cnt + ins.to(i32)

    # ---- commit TCP state (slot-one-hot wheres) ----
    w2 = oh & p2[:, None]
    w3 = oh & p3[:, None]
    w23 = oh & take_tcp[:, None]

    def wr(a, new, m):
        return _W(m, new[:, None], a)

    def wr4(a, new, m):
        return _W(m[:, :, None, None], new[:, None], a)

    fin3 = p3 & fin_goes
    lane_sum = torch.stack(lane_valid, dim=1).sum(dim=1)
    ts = dataclasses.replace(
        ts,
        st=_W(oh & fin3[:, None], T.FINWAIT1, ts.st),
        fin_sent=ts.fin_sent | (oh & fin3[:, None]),
        snd_una=wr(ts.snd_una, una1, w3),
        snd_nxt=wr(ts.snd_nxt, new_nxt, w3),
        snd_max=wr(ts.snd_max, new_max, w3),
        cwnd=wr(ts.cwnd, cwnd1, w3),
        dupacks=_W(w3, 0, ts.dupacks),
        backoff=_W(w3, 0, ts.backoff),
        rto_expire=wr(ts.rto_expire, new_expire, w3),
        srtt=wr(ts.srtt, n_srtt, w3),
        rttvar=wr(ts.rttvar, n_rttvar, w3),
        rto=wr(ts.rto, n_rto, w3),
        rtt_pending=wr(ts.rtt_pending, rp, w3),
        rtt_seq=wr(ts.rtt_seq, rs, w3),
        rtt_ts=wr(ts.rtt_ts, rt, w3),
        retransmits=ts.retransmits + _W(w3, rtx_count[:, None], 0),
        peer_wnd=wr(ts.peer_wnd, peer_wnd1, w23),
        rcv_nxt=wr(ts.rcv_nxt, rcv1, w2),
        ooo=wr4(ts.ooo, ooo1, w2),
        sacked=wr4(ts.sacked, sacked2, w3),
        delivered=ts.delivered + _W(w2, delivered_delta[:, None], 0),
        segs_in=ts.segs_in + w23.to(i64),
        segs_out=ts.segs_out + _W(w3, lane_sum[:, None], 0),
    )
    mstate = spec.apply(mstate, take_tcp, host_ids, delivered_delta)

    # ---- emissions: P3 data/FIN lanes; the P2 ACK rides lane 0 ----
    dst = torch.clamp(v_rhost, 0, tables.num_global_hosts - 1)
    dst_node = tables.host_node[dst.to(i64)].to(i64)
    sn = src_node.to(i64)
    lat = tables.lat_ns[sn, dst_node]
    rel = tables.rel[sn, dst_node]
    loopb = dst == host_ids
    in_btx = now < cfg.bootstrap_end_ns

    if p.use_sack:
        sack_s, sack_e = T.lowest_ooo_block(ooo1)
    else:
        sack_s = sack_e = torch.zeros((h,), dtype=i64, device=dev)

    wnd_col = torch.full((h,), p.rcv_wnd, dtype=i64, device=dev)
    l_valid2, l_data2, l_size2 = [], [], []
    for lane in range(nseg):
        use_ack = p2 if lane == 0 else zb
        lv = (lane_valid[lane] & p3) | use_ack
        lflags = _W(lane_fin[lane], FLAG_FIN | FLAG_ACK, FLAG_ACK).to(i32)
        ldata = T._mk_seg(
            v_lport, v_rport,
            _W(use_ack, new_nxt, lane_seq_w[lane]),
            rcv1, lflags,
            _W(use_ack, 0, lane_len[lane]),
            wnd_col,
            sack_s=_W(use_ack, sack_s, 0),
            sack_e=_W(use_ack, sack_e, 0),
        )
        l_valid2.append(lv)
        l_data2.append(ldata)
        l_size2.append(_W(use_ack, 0, lane_len[lane]) + p.header_bytes)

    lv_all = torch.stack(l_valid2, dim=1)
    lsz_all = torch.stack(l_size2, dim=1).to(i64)
    unroutable_l = lv_all & (lat >= TIME_MAX)[:, None]
    # loss draws: the handler's lane index (P2's ACK is the control lane)
    lanes_u = torch.arange(nseg, dtype=i64, device=dev)[None, :]
    draw_lane = _W(p2[:, None], nseg, lanes_u)
    ctrs = (c.rng_counter[:, None] + draws + draw_lane) & rng.MASK32
    loss_u = rng.uniform_f32_grid(c.key_data, ctrs)
    pass_l = loss_u < rel[:, None]
    kept_l = lv_all & ~unroutable_l & pass_l
    dropped_l = lv_all & ~unroutable_l & ~pass_l
    if cfg.use_netstack:
        charge_l = (lv_all & ~unroutable_l) & ~loopb[:, None] & ~in_btx[:, None]
        deps, tx_tok, tx_last = netstack.tb_depart_lanes(
            net.tx_tokens, net.tx_last, net.tx_refill, now, lsz_all, charge_l
        )
        we_col = window_end[:, None] if window_end.ndim else window_end
        deliver_l = torch.maximum(deps + lat[:, None], we_col)
        net = dataclasses.replace(
            net,
            tx_tokens=tx_tok,
            tx_last=tx_last,
            bytes_sent=net.bytes_sent + _W(kept_l, lsz_all, 0).sum(dim=1),
        )
    else:
        deliver_l = torch.maximum(now + lat, window_end)[:, None].expand(h, nseg)

    seq = c.seq
    pkt_kind = torch.full((h,), KIND_PACKET, dtype=i32, device=dev)
    for lane in range(nseg):
        kept = kept_l[:, lane]
        has_room = obfill < o_cap
        write = kept & has_room
        at = (lane_idx_ob == obfill[:, None]) & write[:, None]
        ptie = pack_tie(pkt_kind, host_ids, seq)
        obv = obv | at
        obd = _W(at, dst[:, None], obd)
        obt = _W(at, deliver_l[:, lane][:, None], obt)
        obtie = _W(at, ptie[:, None], obtie)
        obdata = _W(at[:, :, None], l_data2[lane][:, None, :], obdata)
        obaux = _W(at, (lsz_all[:, lane].to(i32) & AUX_SIZE_MASK)[:, None], obaux)
        obfill = obfill + write.to(i32)
        obover = obover + (kept & ~has_room).to(i32)
        seq = (seq + kept.to(i64)) & rng.MASK32
    packets_sent = c.packets_sent + kept_l.sum(dim=1)
    packets_dropped = c.packets_dropped + dropped_l.sum(dim=1)
    packets_unroutable = c.packets_unroutable + unroutable_l.sum(dim=1)
    trk_bytes_ctrl, trk_bytes_data, trk_retrans = c.trk_bytes_ctrl, c.trk_bytes_data, c.trk_retrans
    if cfg.tracker:
        hdr = int(getattr(model, "WIRE_HEADER_BYTES", 0))
        is_ctrl = kept_l & (lsz_all <= hdr)
        trk_bytes_ctrl = trk_bytes_ctrl + _W(is_ctrl, lsz_all, 0).sum(dim=1)
        trk_bytes_data = trk_bytes_data + _W(kept_l & ~is_ctrl, lsz_all, 0).sum(dim=1)
        trk_retrans = trk_retrans + _W(p3, rtx_count, 0)
    if cfg.use_dynamic_runahead:
        cross = kept_l & (dst != host_ids)[:, None] & (lat < TIME_MAX)[:, None]
        used = _W(cross, lat[:, None], TIME_MAX)
        used = used.amin() if min_used.ndim == 0 else used.reshape(
            min_used.shape[0], -1).amin(dim=1)
        min_used = torch.minimum(min_used, used)

    return dataclasses.replace(
        c,
        q=q, net=net, ts=ts, mstate=mstate,
        obv=obv, obd=obd, obt=obt, obtie=obtie,
        obdata=obdata, obaux=obaux, obfill=obfill, obover=obover,
        f_time=f_time, f_tie=f_tie, f_kind=f_kind,
        f_data=f_data, f_aux=f_aux, f_head=f_head, f_cnt=f_cnt,
        seq=seq,
        rng_counter=(c.rng_counter + stride * take_tcp.to(i64)) & rng.MASK32,
        events_handled=c.events_handled + take_tcp.to(i64),
        packets_sent=packets_sent,
        packets_dropped=packets_dropped,
        packets_unroutable=packets_unroutable,
        trk_bytes_ctrl=trk_bytes_ctrl,
        trk_bytes_data=trk_bytes_data,
        trk_retrans=trk_retrans,
        min_used=min_used,
        alive=alive & take,
        rejected=rejected,
    )


def pump_carry_finish(st: SimState, c: PumpCarry, model, cfg: EngineConfig):
    """Merge the carry back: flush the leftover defer FIFO into the queue
    (one batched self-push), rebuild the outbox, merge the TcpState."""
    spec: TcpPumpSpec = model.pump_spec
    q = c.q
    if cfg.use_netstack:
        k = c.f_time.shape[1]
        lane = torch.arange(k, device=c.f_head.device)[None, :]
        live = (lane >= c.f_head[:, None]) & (lane < c.f_cnt[:, None])
        q = equeue.push_self_lanes(
            q, valid=live, time=c.f_time, tie=c.f_tie, kind=c.f_kind,
            data=c.f_data, aux=c.f_aux,
        )
    ob = dataclasses.replace(
        st.outbox, valid=c.obv, dst=c.obd, time=c.obt, tie=c.obtie,
        data=c.obdata, aux=c.obaux, fill=c.obfill, overflow=c.obover,
    )
    st = dataclasses.replace(
        st,
        queue=q,
        net=c.net,
        model=spec.set_tcp(c.mstate, c.ts),
        outbox=ob,
        seq=c.seq,
        rng_counter=c.rng_counter,
        events_handled=c.events_handled,
        packets_sent=c.packets_sent,
        packets_dropped=c.packets_dropped,
        packets_unroutable=c.packets_unroutable,
        min_used_lat=c.min_used,
    )
    if cfg.tracker:
        st = dataclasses.replace(
            st,
            tracker=dataclasses.replace(
                st.tracker,
                bytes_ctrl=c.trk_bytes_ctrl,
                bytes_data=c.trk_bytes_data,
                retrans_segs=c.trk_retrans,
            ),
        )
    replicas = replicas_of(st)
    if replicas is None:
        return st, c.rejected.any()
    return st, c.rejected.reshape(replicas, -1).any(dim=1)


def pump_stage(st: SimState, window_end, model, tables: RoutingTables,
               cfg: EngineConfig, debug_out: "list | None" = None):
    """Run cfg.pump_k pump microsteps per host. Returns (state,
    any_rejected); on an ensemble's rows view, window_end and the
    rejected flags are [R]. A microstep on an all-dead carry is the
    identity (every write is masked by take/alive), so the loop may stop
    early; the eager debug path runs every step for its tallies."""
    window_end = per_row(st, window_end)
    c = pump_carry_init(st, model, tables, cfg)
    for _ in range(cfg.pump_k):
        if debug_out is None and not bool(c.alive.any()):
            break
        c = pump_microstep(c, window_end, model, tables, cfg, debug_out)
    return pump_carry_finish(st, c, model, cfg)
