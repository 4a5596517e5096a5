"""CPU-side TCP for managed processes: a compact per-connection state
machine with the reference's semantics (port of shadow_tpu/hostk/tcp.py).

Rebuilds the reference TCP (reference: src/main/host/descriptor/tcp.c —
state space :38-85, `_tcp_processPacket` receive engine :2006-2372,
`_tcp_flush` send engine :1265-1444, RFC 6298 RTT/RTO :1135-1170,
retransmit timers :1062-1504, TIMEWAIT close timer :771, listener child
multiplexing :2087-2101; Reno hooks tcp_cong_reno.c) for the managed-
process tier. The device tier has the same machine vectorized over [H,S]
rows (transport/tcp.py); constants are kept identical so both
tiers model the same network behavior.

Sequence numbers are unbounded Python ints (no 32-bit wrap): simulation-
internal, never on a real wire. ISS is 0 for determinism (the reference
draws it from the host RNG; fixed-0 keeps traces diffable and spends no
RNG counters).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

from shadow_tpu_torch.hostk.descriptor import (
    EAGAIN,
    ECONNREFUSED,
    ECONNRESET,
    EINVAL,
    EISCONN,
    ENOTCONN,
    EPIPE,
    File,
)
from shadow_tpu_torch.simtime import NS_PER_MS, NS_PER_SEC

if TYPE_CHECKING:
    from shadow_tpu_torch.hostk.kernel import HostKernel

# states (tcp.c:38-50)
CLOSED = 0
LISTEN = 1
SYN_SENT = 2
SYN_RCVD = 3
ESTABLISHED = 4
FIN_WAIT_1 = 5
FIN_WAIT_2 = 6
CLOSING = 7
TIME_WAIT = 8
CLOSE_WAIT = 9
LAST_ACK = 10

STATE_NAMES = {
    CLOSED: "CLOSED",
    LISTEN: "LISTEN",
    SYN_SENT: "SYN_SENT",
    SYN_RCVD: "SYN_RCVD",
    ESTABLISHED: "ESTABLISHED",
    FIN_WAIT_1: "FIN_WAIT_1",
    FIN_WAIT_2: "FIN_WAIT_2",
    CLOSING: "CLOSING",
    TIME_WAIT: "TIME_WAIT",
    CLOSE_WAIT: "CLOSE_WAIT",
    LAST_ACK: "LAST_ACK",
}

FLAG_SYN = 1
FLAG_ACK = 2
FLAG_FIN = 4
FLAG_RST = 8

MSS = 1460
RECV_WND = 256 * 1024  # initial advertised window; autotunes upward
RECV_WND_MAX = 4 * 1024 * 1024  # autotune ceiling (tcp.c:498-655 rmem cap)
SND_BUF = 256 * 1024  # initial send buffer; autotunes with cwnd
SND_BUF_MAX = 4 * 1024 * 1024
INIT_CWND_SEGS = 10
RTO_INIT_NS = NS_PER_SEC
RTO_MIN_NS = 200 * NS_PER_MS
RTO_MAX_NS = 60 * NS_PER_SEC
TIMEWAIT_NS = 60 * NS_PER_SEC  # tcp.c:771
HEADER_BYTES = 40  # IPv4+TCP wire overhead, matches device tier


@dataclasses.dataclass
class Segment:
    """Simulated TCP segment (the packet.c header fields we model)."""

    src_ip: int
    src_port: int
    dst_ip: int
    dst_port: int
    flags: int
    seq: int
    ack: int
    wnd: int
    payload: bytes = b""
    # selective-ACK blocks: up to 4 (start, end) received ranges above the
    # cumulative ACK (the reference answers retransmission queries from a
    # C++ range tally, tcp_retransmit_tally.cc)
    sack: "tuple" = ()

    def wire_len(self) -> int:
        opt = 4 + 8 * len(self.sack) if self.sack else 0
        return len(self.payload) + HEADER_BYTES + opt

    def flag_str(self) -> str:
        s = "".join(
            n for bit, n in ((FLAG_SYN, "S"), (FLAG_ACK, "A"), (FLAG_FIN, "F"), (FLAG_RST, "R"))
            if self.flags & bit
        )
        return s or "."


class TcpSocket(File):
    """One TCP endpoint. Listener sockets hold an accept queue of child
    sockets (tcp.c:97-115 TCPServer); connected sockets hold the full
    send/receive/retransmit machine (struct _TCP, tcp.c:118-247)."""

    def __init__(self, host: "HostKernel"):
        super().__init__()
        self.host = host
        self.state = CLOSED
        self.error = 0  # pending SO_ERROR (positive errno)

        self.local_ip = 0
        self.local_port = 0
        self.remote_ip = 0
        self.remote_port = 0
        self.bound_port = 0  # registered in host.ports

        # listener side
        self.backlog = 0
        self.accept_queue: "list[TcpSocket]" = []  # ESTABLISHED children
        self.syn_children: "dict[tuple[int, int], TcpSocket]" = {}
        self.parent: Optional[TcpSocket] = None

        # send side (tcp.c `send` block)
        self.snd_buf = bytearray()  # unsent+unacked bytes; offset 0 == snd_una
        self.snd_una = 0
        self.snd_nxt = 0
        self.iss = 0
        self.fin_pending = False  # app closed; FIN after buffered data
        self.fin_seq: Optional[int] = None  # seq consumed by our FIN once sent
        self.fin_acked = False
        self.peer_wnd = RECV_WND
        self.cwnd = INIT_CWND_SEGS * MSS
        self.ssthresh = 1 << 62
        self.dupacks = 0
        self.in_recovery = False
        self.recovery_point = 0
        # SACK scoreboard: sorted disjoint (start, end) ranges the peer
        # holds above snd_una (tcp_retransmit_tally.cc's acked-range set)
        self.sacked: "list[tuple[int, int]]" = []
        self._last_rexmit = -1  # first hole retransmitted this recovery
        self.retransmits = 0  # stats: segments re-sent (loss recovery + RTO)
        self.snd_max = 0  # highest seq+len ever put on the wire
        # buffer autotuning (tcp.c:498-655): both caps grow toward 2xBDP
        self.rcv_wnd_cap = RECV_WND
        self.snd_buf_cap = SND_BUF
        self.rtt_est = 0  # receiver-side RTT estimate (handshake-timed)
        self._conn_t0 = 0
        self._at_t0 = 0
        self._at_bytes = 0

        # receive side (tcp.c `receive` block)
        self.irs = 0
        self.rcv_nxt = 0
        self.rcv_buf = bytearray()  # in-order, not yet read by the app
        self.ooo: "dict[int, bytes]" = {}  # seq -> payload, out-of-order
        self.fin_rcvd_seq: Optional[int] = None
        self.eof_signaled = False

        # timing (tcp.c `timing` + retransmit blocks)
        self.srtt = 0
        self.rttvar = 0
        self.rto = RTO_INIT_NS
        self.backoff = 0
        self.rto_deadline: Optional[int] = None  # lazy timer (desiredTimerExpiration)
        self.ts_seq: Optional[int] = None  # one in-flight RTT sample (Karn)
        self.ts_time = 0
        self.persist_deadline: Optional[int] = None  # zero-window probe timer

    # --- helpers ----------------------------------------------------------

    def _k(self):
        return self.host.kernel

    def conn_key(self) -> "tuple[int, int, int]":
        return (self.local_port, self.remote_ip, self.remote_port)

    def _set_state(self, st: int) -> None:
        # (tcp.c:660 _tcp_setState incl. the TIMEWAIT/CLOSED teardown)
        if st == self.state:
            return
        self.state = st
        k = self._k()
        if st == TIME_WAIT:
            deadline = k.now + TIMEWAIT_NS
            self._rto_cancel()
            k._push(deadline, lambda: self._timewait_expire())
        if st == CLOSED:
            self.host.drop_tcp_conn(self)
        self.notify()

    def _timewait_expire(self) -> None:
        if self.state == TIME_WAIT:
            self._set_state(CLOSED)

    def _fail(self, errno_: int) -> None:
        """Connection is dead (RST / refused): error every future op."""
        self.error = errno_
        self._rto_cancel()
        self._set_state(CLOSED)
        self.notify()

    # --- poll interface ---------------------------------------------------

    def readable(self) -> bool:
        if self.state == LISTEN:
            return len(self.accept_queue) > 0
        if self.error:
            return True
        if len(self.rcv_buf) > 0:
            return True
        return self._at_eof()

    def writable(self) -> bool:
        if self.error:
            return True
        if self.state in (ESTABLISHED, CLOSE_WAIT):
            return len(self.snd_buf) < self.snd_buf_cap
        return self.state in (CLOSED,) and self.error != 0

    def err(self) -> bool:
        return self.error != 0

    def hup(self) -> bool:
        return self.state == CLOSED and (self.error != 0 or self.eof_signaled)

    def _at_eof(self) -> bool:
        return (
            self.fin_rcvd_seq is not None
            and self.rcv_nxt >= self.fin_rcvd_seq + 1
            and len(self.rcv_buf) == 0
        )

    # --- user API (tcp.c:1652-1771, 2401-2540) ----------------------------

    def listen(self, backlog: int) -> int:
        if self.state not in (CLOSED, LISTEN):
            return -EINVAL
        if self.bound_port == 0:
            return -EINVAL  # must bind first (the shim binds explicitly)
        self.backlog = max(1, backlog)
        self.state = LISTEN
        return 0

    def connect(self, ip: int, port: int) -> int:
        if self.state == ESTABLISHED:
            return -EISCONN
        if self.state != CLOSED or self.error:
            return -EINVAL
        self.remote_ip = ip
        self.remote_port = port
        self.local_ip = self.host.ip
        if self.bound_port == 0:
            self.host.bind_tcp_ephemeral(self)
        self.local_port = self.bound_port
        self.host.add_tcp_conn(self)
        self.snd_una = self.iss
        self.snd_nxt = self.iss
        self._set_state(SYN_SENT)
        self._conn_t0 = self._k().now
        self._tx(FLAG_SYN, seq=self.snd_nxt)
        self.snd_nxt += 1  # SYN consumes a sequence number
        self._rto_arm()
        return -115  # EINPROGRESS; waiter layer blocks if the fd is blocking

    def accept_pop(self) -> Optional["TcpSocket"]:
        if not self.accept_queue:
            return None
        child = self.accept_queue.pop(0)
        child.parent = None
        return child

    def send(self, data: bytes) -> int:
        if self.error:
            e, self.error = self.error, 0
            return -e
        if self.state not in (ESTABLISHED, CLOSE_WAIT):
            if self.state in (SYN_SENT, SYN_RCVD):
                return -EAGAIN  # not yet connected (blocking layer waits)
            return -EPIPE
        space = self.snd_buf_cap - len(self.snd_buf)
        if space <= 0:
            return -EAGAIN
        take = data[:space]
        self.snd_buf.extend(take)
        self._flush()
        return len(take)

    def peek(self, n: int) -> "bytes | int":
        """MSG_PEEK: read without consuming (no window update)."""
        if self.state == LISTEN:
            return -EINVAL
        if self.error:
            e, self.error = self.error, 0
            return -e
        if self.rcv_buf:
            return bytes(self.rcv_buf[:n])
        if self._at_eof():
            return b""
        if self.state in (CLOSED,):
            return -ENOTCONN
        return -EAGAIN

    def recv(self, n: int) -> "bytes | int":
        if self.state == LISTEN:
            return -EINVAL
        if self.error:
            e, self.error = self.error, 0
            return -e
        if self.rcv_buf:
            out = bytes(self.rcv_buf[:n])
            del self.rcv_buf[:n]
            # receive window re-opened: send a window update if we'd been
            # pinching it (tcp.c:2469 window-update task)
            if len(out) > 0 and self.state in (ESTABLISHED, FIN_WAIT_1, FIN_WAIT_2):
                if self._adv_wnd() > 0 and self._adv_wnd() - len(out) <= 0:
                    self._tx(FLAG_ACK, seq=self.snd_nxt)
            return out
        if self._at_eof():
            self.eof_signaled = True
            return b""
        if self.state in (CLOSED,):
            return -ENOTCONN
        return -EAGAIN

    def shutdown_write(self) -> int:
        if self.state in (ESTABLISHED, SYN_RCVD):
            self.fin_pending = True
            self._set_state(FIN_WAIT_1)
            self._flush()
            return 0
        if self.state == CLOSE_WAIT:
            self.fin_pending = True
            self._set_state(LAST_ACK)
            self._flush()
            return 0
        if self.state == SYN_SENT:
            self._fail(ECONNRESET)
            return 0
        return -ENOTCONN

    def app_close(self) -> None:
        """close(2): orderly release (tcp.c:2761-2789)."""
        if self.state == LISTEN:
            for c in list(self.syn_children.values()) + self.accept_queue:
                c.parent = None
                c.app_close()
            self.syn_children.clear()
            self.accept_queue.clear()
            self._set_state(CLOSED)
            return
        if self.state in (ESTABLISHED, SYN_RCVD, CLOSE_WAIT):
            self.shutdown_write()
        elif self.state == SYN_SENT:
            self._fail(0)
        # in FIN_WAIT*/CLOSING/TIME_WAIT/LAST_ACK the machine finishes alone

    # --- send engine (tcp.c:1265-1444 _tcp_flush) -------------------------

    def _adv_wnd(self) -> int:
        ooo_bytes = sum(len(v) for v in self.ooo.values())
        return max(0, self.rcv_wnd_cap - len(self.rcv_buf) - ooo_bytes)

    def _flight(self) -> int:
        return self.snd_nxt - self.snd_una - (
            1 if self.fin_seq is not None and self.snd_nxt > self.fin_seq else 0
        )

    def _flush(self) -> None:
        if self.state not in (ESTABLISHED, CLOSE_WAIT, FIN_WAIT_1, CLOSING, LAST_ACK):
            return
        limit = self.snd_una + min(self.cwnd, max(self.peer_wnd, 0))
        sent_any = False
        while True:
            # bytes in snd_buf start at seq snd_una; unsent start at snd_nxt
            unsent_off = self.snd_nxt - self.snd_una
            if unsent_off >= len(self.snd_buf):
                break
            if self.snd_nxt >= limit:
                break
            n = min(MSS, len(self.snd_buf) - unsent_off, limit - self.snd_nxt)
            payload = bytes(self.snd_buf[unsent_off : unsent_off + n])
            self._tx(FLAG_ACK, seq=self.snd_nxt, payload=payload)
            if self.ts_seq is None:  # one unambiguous RTT sample (Karn)
                self.ts_seq = self.snd_nxt
                self.ts_time = self._k().now
            self.snd_nxt += n
            sent_any = True
        # FIN rides after all data (fin "should send" flag, tcp.c flow)
        if (
            self.fin_pending
            and self.fin_seq is None
            and self.snd_nxt - self.snd_una >= len(self.snd_buf)
        ):
            self.fin_seq = self.snd_nxt
            self._tx(FLAG_ACK | FLAG_FIN, seq=self.snd_nxt)
            self.snd_nxt += 1
            sent_any = True
        if sent_any or self._flight() > 0 or (self.fin_seq is not None and not self.fin_acked):
            self._rto_arm()
        # zero-window: arm the persist probe so a lost window update can't
        # deadlock the connection
        if (
            self.peer_wnd <= 0
            and (len(self.snd_buf) > self.snd_nxt - self.snd_una or self.fin_pending)
            and self.persist_deadline is None
        ):
            self._persist_arm()

    def _persist_arm(self) -> None:
        k = self._k()
        deadline = k.now + max(self.rto, RTO_MIN_NS)
        self.persist_deadline = deadline
        k._push(deadline, lambda d=deadline: self._persist_fire(d))

    def _persist_fire(self, deadline: int) -> None:
        if self.persist_deadline != deadline or self.state == CLOSED:
            return
        self.persist_deadline = None
        if self.peer_wnd <= 0 and len(self.snd_buf) > self.snd_nxt - self.snd_una:
            # 1-byte window probe
            off = self.snd_nxt - self.snd_una
            payload = bytes(self.snd_buf[off : off + 1])
            self._tx(FLAG_ACK, seq=self.snd_nxt, payload=payload)
            self.snd_nxt += 1
            self._persist_arm()

    # --- retransmit timer (tcp.c:1062-1134,1445-1504) ---------------------

    def _rto_arm(self) -> None:
        k = self._k()
        deadline = k.now + self.rto
        self.rto_deadline = deadline
        k._push(deadline, lambda d=deadline: self._rto_fire(d))

    def _rto_cancel(self) -> None:
        self.rto_deadline = None

    def _rto_fire(self, deadline: int) -> None:
        if self.rto_deadline != deadline or self.state == CLOSED:
            return  # lazy cancellation (desiredTimerExpiration pattern)
        self.rto_deadline = None
        if self.state == SYN_RCVD:
            # lost SYN+ACK: resend until the peer's ACK arrives
            if self.backoff >= 5:
                self._fail(ECONNRESET)
                return
            self.backoff += 1
            self.rto = min(self.rto * 2, RTO_MAX_NS)
            self._tx(FLAG_SYN | FLAG_ACK, seq=self.iss)
            self._rto_arm()
            return
        if self.state == SYN_SENT:
            if self.backoff >= 5:
                self._fail(ECONNREFUSED)  # ETIMEDOUT in Linux; refused is
                return  # what apps usually see in shadowed nets
            self.backoff += 1
            self.rto = min(self.rto * 2, RTO_MAX_NS)
            self._tx(FLAG_SYN, seq=self.iss)
            self._rto_arm()
            return
        if self._flight() <= 0 and (self.fin_seq is None or self.fin_acked):
            return
        # RTO: collapse to loss state (tcp_cong_reno.c timeout hook)
        self.backoff += 1
        if self.backoff > 10:
            self._fail(ECONNRESET)
            return
        self.ssthresh = max(self._flight() // 2, 2 * MSS)
        self.cwnd = MSS
        self.in_recovery = False
        self.dupacks = 0
        self.sacked = []  # conservative: forget SACK state across RTO
        self._last_rexmit = -1
        self.snd_nxt = self.snd_una  # go-back-N rewind, like the device tier
        self.ts_seq = None  # Karn: no sample across retransmit
        self.rto = min(self.rto * 2, RTO_MAX_NS)
        if self.fin_seq is not None and not self.fin_acked:
            self.fin_seq = None  # will re-emit FIN after data
        self._flush()
        self._rto_arm()

    def _rtt_update(self, m: int) -> None:
        # RFC 6298 (tcp.c:1135-1170)
        if self.srtt == 0:
            self.srtt = m
            self.rttvar = m // 2
        else:
            self.rttvar = (3 * self.rttvar + abs(self.srtt - m)) // 4
            self.srtt = (7 * self.srtt + m) // 8
        self.rto = min(max(self.srtt + 4 * self.rttvar, RTO_MIN_NS), RTO_MAX_NS)

    # --- wire -------------------------------------------------------------

    def _tx(self, flags: int, seq: int, payload: bytes = b"", sack: "tuple" = ()) -> None:
        if payload or (flags & FLAG_FIN):
            end = seq + len(payload) + (1 if flags & FLAG_FIN else 0)
            if seq < self.snd_max:
                self.retransmits += 1
                self.host.kernel.tcp_retransmits += 1
            if end > self.snd_max:
                self.snd_max = end
        seg = Segment(
            src_ip=self.local_ip or self.host.ip,
            src_port=self.local_port or self.bound_port,
            dst_ip=self.remote_ip,
            dst_port=self.remote_port,
            flags=flags,
            seq=seq,
            ack=self.rcv_nxt if (flags & FLAG_ACK) else 0,
            wnd=self._adv_wnd(),
            payload=payload,
            sack=sack,
        )
        self.host.kernel.send_segment(self.host, seg)

    def _sack_blocks(self) -> "tuple":
        """Receiver: up to 4 merged out-of-order ranges above rcv_nxt."""
        if not self.ooo or not getattr(self._k(), "tcp_sack", True):
            return ()
        ranges: "list[tuple[int, int]]" = []
        for sq, pl in sorted(self.ooo.items()):
            e = sq + len(pl)
            if ranges and sq <= ranges[-1][1]:
                if e > ranges[-1][1]:
                    ranges[-1] = (ranges[-1][0], e)
            else:
                ranges.append((sq, e))
        return tuple(ranges[:4])

    def _sack_update(self, blocks: "tuple") -> None:
        """Sender: merge the peer's SACK blocks into the scoreboard."""
        merged = self.sacked + [
            (max(s, self.snd_una), e) for (s, e) in blocks if e > self.snd_una
        ]
        merged.sort()
        out: "list[tuple[int, int]]" = []
        for s_, e_ in merged:
            if out and s_ <= out[-1][1]:
                if e_ > out[-1][1]:
                    out[-1] = (out[-1][0], e_)
            else:
                out.append((s_, e_))
        self.sacked = out[:32]

    # --- receive engine (tcp.c:2006-2372 _tcp_processPacket) --------------

    def on_segment(self, seg: Segment) -> None:
        k = self._k()
        f_syn = bool(seg.flags & FLAG_SYN)
        f_ack = bool(seg.flags & FLAG_ACK)
        f_fin = bool(seg.flags & FLAG_FIN)
        f_rst = bool(seg.flags & FLAG_RST)

        if f_rst:
            # (tcp.c:2020-2035)
            if self.state == SYN_SENT:
                self._fail(ECONNREFUSED)
            elif self.state not in (CLOSED, TIME_WAIT):
                self._fail(ECONNRESET)
            return

        if self.state == SYN_SENT:
            if f_syn and f_ack and seg.ack == self.iss + 1:
                self.irs = seg.seq
                self.rcv_nxt = seg.seq + 1
                self.snd_una = seg.ack
                self.peer_wnd = seg.wnd
                self.backoff = 0
                self._rtt_update(max(k.now - self.ts_time, 1) if self.ts_time else RTO_MIN_NS)
                if self._conn_t0:
                    self.rtt_est = max(k.now - self._conn_t0, 1)
                self._set_state(ESTABLISHED)
                self._tx(FLAG_ACK, seq=self.snd_nxt)
                self._rto_cancel()
                self._flush()
            return

        if self.state == SYN_RCVD:
            if f_syn and not f_ack:
                # duplicate SYN (our SYN+ACK was lost): resend it
                self._tx(FLAG_SYN | FLAG_ACK, seq=self.iss)
                return
            if f_ack and seg.ack == self.iss + 1:
                self.snd_una = seg.ack
                self.peer_wnd = seg.wnd
                if self._conn_t0:
                    self.rtt_est = max(k.now - self._conn_t0, 1)
                self._rto_cancel()
                self._set_state(ESTABLISHED)
                if self.parent is not None:
                    self.parent.promote_child(self)
                # fall through: the ACK may carry data

        # --- ACK processing (drives Reno, tcp_cong_reno.c hooks) ----------
        if f_ack and self.state in (
            ESTABLISHED,
            FIN_WAIT_1,
            FIN_WAIT_2,
            CLOSING,
            CLOSE_WAIT,
            LAST_ACK,
        ):
            self.peer_wnd = seg.wnd
            if self.peer_wnd > 0:
                self.persist_deadline = None
            if seg.sack:
                self._sack_update(seg.sack)
            if seg.ack > self.snd_una:
                acked = seg.ack - self.snd_una
                data_acked = acked
                if self.fin_seq is not None and seg.ack >= self.fin_seq + 1:
                    self.fin_acked = True
                    data_acked -= 1
                del self.snd_buf[:data_acked]
                self.snd_una = seg.ack
                if self.snd_nxt < self.snd_una:
                    self.snd_nxt = self.snd_una
                self.sacked = [r for r in self.sacked if r[1] > self.snd_una]
                self.backoff = 0
                self.dupacks = 0
                if self.ts_seq is not None and seg.ack > self.ts_seq:
                    self._rtt_update(max(k.now - self.ts_time, 1))
                    self.ts_seq = None
                if self.in_recovery:
                    if seg.ack >= self.recovery_point:
                        self.in_recovery = False
                        self._last_rexmit = -1  # recovery over: marks expire
                        self.cwnd = self.ssthresh
                    else:  # partial ack: retransmit next hole
                        self._retransmit_one()
                elif self.cwnd < self.ssthresh:
                    self.cwnd += min(acked, MSS)  # slow start
                else:
                    self.cwnd += max(MSS * MSS // self.cwnd, 1)  # CA
                # send-buffer autotune: track 2x the congestion window so
                # the app can keep the pipe full (tcp.c:498-655 wmem side)
                if (
                    getattr(k, "tcp_autotune", True)
                    and 2 * self.cwnd > self.snd_buf_cap
                ):
                    self.snd_buf_cap = min(2 * self.cwnd, SND_BUF_MAX)
                if self._flight() > 0 or (self.fin_seq is not None and not self.fin_acked):
                    self._rto_arm()
                else:
                    self._rto_cancel()
                self.notify()  # sender buffer drained: writers wake
            elif (
                seg.ack == self.snd_una
                and not f_fin
                and len(seg.payload) == 0
                and self._flight() > 0
            ):
                self.dupacks += 1
                if self.dupacks == 3 and not self.in_recovery:
                    # fast retransmit + recovery (reno duplicate-ack hook)
                    self.ssthresh = max(self._flight() // 2, 2 * MSS)
                    self.in_recovery = True
                    self.recovery_point = self.snd_nxt
                    self.cwnd = self.ssthresh + 3 * MSS
                    self.ts_seq = None
                    self._retransmit_one()
                elif self.in_recovery:
                    self.cwnd += MSS
                    if self.sacked:
                        # march one hole per incoming ACK (RFC 6675-style
                        # pacing; the tally answers "what is lost")
                        self._retransmit_one()
                    self._flush()
            self._flush()

        # --- in-band data (+ FIN sequencing, OOO reassembly) --------------
        if self.state in (ESTABLISHED, FIN_WAIT_1, FIN_WAIT_2):
            advanced = False
            if seg.payload:
                if seg.seq == self.rcv_nxt:
                    if len(seg.payload) <= self._adv_wnd() + MSS:  # window slack
                        self.rcv_buf.extend(seg.payload)
                        self.rcv_nxt += len(seg.payload)
                        advanced = True
                        self._drain_ooo()
                elif seg.seq > self.rcv_nxt:
                    self.ooo.setdefault(seg.seq, seg.payload)
                # below rcv_nxt: pure duplicate, just re-ACK
            if f_fin:
                fin_seq = seg.seq + len(seg.payload)
                self.fin_rcvd_seq = fin_seq
                if fin_seq == self.rcv_nxt:
                    self.rcv_nxt += 1
                    advanced = True
                    if self.state == ESTABLISHED:
                        self._set_state(CLOSE_WAIT)
                    elif self.state == FIN_WAIT_1:
                        if self.fin_acked:
                            self._set_state(TIME_WAIT)
                        else:
                            self._set_state(CLOSING)
                    elif self.state == FIN_WAIT_2:
                        self._set_state(TIME_WAIT)
            if advanced and getattr(k, "tcp_autotune", True):
                # receive-window autotune: measure delivered bytes per RTT
                # and track 2x that (tcp.c:498-655 rmem side); the RTT is
                # the sender-side estimate when we have one, else the
                # handshake-timed estimate
                self._at_bytes += len(seg.payload)
                rtt = self.srtt or self.rtt_est
                if rtt > 0:
                    if self._at_t0 == 0:
                        self._at_t0 = k.now
                    elif k.now - self._at_t0 >= rtt:
                        target = 2 * self._at_bytes
                        if target > self.rcv_wnd_cap:
                            self.rcv_wnd_cap = min(target, RECV_WND_MAX)
                        self._at_t0 = k.now
                        self._at_bytes = 0
            if seg.payload or f_fin:
                # ACK everything that arrived (immediate-ACK policy; the
                # reference's delayed ACK is a latency optimization only)
                self._tx(FLAG_ACK, seq=self.snd_nxt, sack=self._sack_blocks())
            if advanced:
                self.notify()

        # --- closing-state ACK bookkeeping --------------------------------
        if self.state == FIN_WAIT_1 and self.fin_acked:
            self._set_state(FIN_WAIT_2)
        elif self.state == CLOSING and self.fin_acked:
            self._set_state(TIME_WAIT)
        elif self.state == LAST_ACK and self.fin_acked:
            self._set_state(CLOSED)
        elif self.state == TIME_WAIT and f_fin:
            self._tx(FLAG_ACK, seq=self.snd_nxt)  # re-ACK a retransmitted FIN

    def _retransmit_one(self) -> None:
        """Retransmit the first SACK hole (the scoreboard's answer to
        "what should be retransmitted", tcp_retransmit_tally.cc); with no
        SACK information this is plain NewReno resend-from-snd_una."""
        data_end = self.snd_una + len(self.snd_buf)
        flight_end = min(self.snd_nxt, data_end)
        start = self.snd_una
        hole = None
        if self.sacked:
            # a hole is only "lost" when a SACK block sits above it
            # (RFC 6675; un-SACKed data above the highest block is merely
            # in flight and must not be re-sent)
            for s_, e_ in self.sacked:
                if e_ <= start:
                    continue
                if s_ >= flight_end:
                    break
                if start < s_:
                    if start > self._last_rexmit:
                        hole = (start, min(s_, start + MSS, flight_end))
                        break
                    start = s_  # already resent; look past this block
                start = max(start, e_)
        elif start < flight_end and start > self._last_rexmit:
            # no SACK information: classic resend-from-snd_una
            hole = (start, min(start + MSS, flight_end))
        if hole is not None:
            off = hole[0] - self.snd_una
            payload = bytes(self.snd_buf[off : hole[1] - self.snd_una])
            self._last_rexmit = hole[0]
            self._tx(FLAG_ACK, seq=hole[0], payload=payload)
        elif self.fin_seq is not None and not self.fin_acked:
            self._tx(FLAG_ACK | FLAG_FIN, seq=self.fin_seq)
        self._rto_arm()

    def _drain_ooo(self) -> None:
        # (unorderedInput drain, tcp.c receive path)
        while self.rcv_nxt in self.ooo:
            chunk = self.ooo.pop(self.rcv_nxt)
            self.rcv_buf.extend(chunk)
            self.rcv_nxt += len(chunk)
        # drop stale entries fully below rcv_nxt
        for s in [s for s in self.ooo if s + len(self.ooo[s]) <= self.rcv_nxt]:
            del self.ooo[s]

    # --- listener side (tcp.c:2087-2101) ----------------------------------

    def on_syn(self, seg: Segment) -> None:
        """LISTEN: spawn a multiplexed child in SYN_RCVD."""
        key = (seg.src_ip, seg.src_port)
        if key in self.syn_children:
            child = self.syn_children[key]
            child._tx(FLAG_SYN | FLAG_ACK, seq=child.iss)  # re-SYNACK
            return
        if len(self.syn_children) + len(self.accept_queue) >= self.backlog:
            return  # silently drop: client retries SYN
        child = TcpSocket(self.host)
        child.parent = self
        child.local_ip = self.host.ip
        child.local_port = self.bound_port
        child.bound_port = self.bound_port
        child.remote_ip = seg.src_ip
        child.remote_port = seg.src_port
        child.irs = seg.seq
        child.rcv_nxt = seg.seq + 1
        child.state = SYN_RCVD
        child._conn_t0 = self.host.kernel.now
        self.syn_children[key] = child
        self.host.add_tcp_conn(child)
        child._tx(FLAG_SYN | FLAG_ACK, seq=child.iss)
        child.snd_nxt = child.iss + 1
        child._rto_arm()

    def promote_child(self, child: "TcpSocket") -> None:
        key = (child.remote_ip, child.remote_port)
        self.syn_children.pop(key, None)
        self.accept_queue.append(child)
        self.notify()  # accept() waiters + EPOLLIN on the listener

    # --- close ------------------------------------------------------------

    def on_close(self, kernel, proc) -> None:
        self.app_close()
        super().on_close(kernel, proc)
