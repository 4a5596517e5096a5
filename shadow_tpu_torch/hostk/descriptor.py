"""Descriptor layer for managed processes: fd table + non-socket file types
(port of shadow_tpu/hostk/descriptor.py).

Rebuilds the reference's descriptor core for the CPU-side host kernel
(reference: src/main/host/descriptor/mod.rs:33-581 File enum {Pipe,
EventFd, Socket, TimerFd} + Descriptor/OpenFile refcounting;
descriptor_table.rs:12-212 POSIX lowest-free fd semantics;
descriptor/{pipe,eventfd,timerfd,shared_buf}.rs; epoll.c:103-320).

Listener discipline mirrors StateEventSource (descriptor/mod.rs:106):
every File keeps a list of callbacks invoked on any state transition;
blocked syscalls (Waiter) and epoll watches both subscribe through it.
Notifications here are immediate rather than deferred through a
CallbackQueue — the kernel is single-threaded per event, so re-entrancy
is bounded by construction.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

VFD_BASE = 1000

# errno values we return (negated over the wire)
EINTR = 4
EFAULT = 14
EPERM = 1
EBADF = 9
EAGAIN = 11
EPIPE = 32
EINVAL = 22
ENOSYS = 38
ENOTCONN = 107
EADDRINUSE = 98
ECONNREFUSED = 111
ECONNRESET = 104
EINPROGRESS = 115
EISCONN = 106
EDESTADDRREQ = 89
EEXIST = 17
ENOENT = 2
EMSGSIZE = 90
ENOTSOCK = 88
ESRCH = 3
ETIMEDOUT = 110
EBUSY = 16
ECHILD = 10

# epoll event bits (uapi)
EPOLLIN = 0x001
EPOLLPRI = 0x002
EPOLLOUT = 0x004
EPOLLERR = 0x008
EPOLLHUP = 0x010
EPOLLRDHUP = 0x2000
EPOLLONESHOT = 1 << 30
EPOLLET = 1 << 31

EPOLL_CTL_ADD = 1
EPOLL_CTL_DEL = 2
EPOLL_CTL_MOD = 3

PROTO_UDP = 0
PROTO_TCP = 1


class File:
    """Base simulated file: listener plumbing + poll interface."""

    def __init__(self):
        self.listeners: "list[Callable[[File], None]]" = []
        self.refcount = 0
        self.closed = False
        self.nonblock = False

    # --- state, overridden by subclasses ---------------------------------

    def readable(self) -> bool:
        return False

    def writable(self) -> bool:
        return False

    def err(self) -> bool:
        return False

    def hup(self) -> bool:
        return False

    def poll_mask(self) -> int:
        m = 0
        if self.readable():
            m |= EPOLLIN
        if self.writable():
            m |= EPOLLOUT
        if self.err():
            m |= EPOLLERR
        if self.hup():
            m |= EPOLLHUP | EPOLLRDHUP
        return m

    # --- listeners (StateEventSource, descriptor/mod.rs:106) -------------

    def add_listener(self, cb: "Callable[[File], None]") -> None:
        self.listeners.append(cb)

    def remove_listener(self, cb: "Callable[[File], None]") -> None:
        if cb in self.listeners:
            self.listeners.remove(cb)

    def notify(self) -> None:
        for cb in list(self.listeners):
            cb(self)

    # --- lifecycle --------------------------------------------------------

    def on_close(self, kernel, proc) -> None:
        """Last descriptor dropped."""
        self.closed = True
        self.notify()


class DescriptorTable:
    """fd -> File with POSIX lowest-free allocation in the UNIFIED real fd
    number space (reference: descriptor_table.rs:12-212). Native
    passthrough fds share the space: the shim claims every virtual number
    with a /dev/null placeholder and reports native opens/closes
    (VSYS_FD_NATIVE), so the allocator never hands out a number a real
    file occupies — select()/dup2-to-low-fd guests see POSIX numbering."""

    def __init__(self):
        self._files: dict[int, File] = {}
        # native fd numbers the shim reported in use (stdio preset)
        self.native_used: set[int] = {0, 1, 2}

    def alloc(self, file: File, min_fd: int = 0) -> int:
        fd = min_fd
        while fd in self._files or fd in self.native_used:
            fd += 1
        self._files[fd] = file
        file.refcount += 1
        return fd

    def get(self, fd: int) -> Optional[File]:
        return self._files.get(fd)

    def dup(self, fd: int) -> Optional[int]:
        f = self._files.get(fd)
        if f is None:
            return None
        return self.alloc(f)

    def alloc_at(self, file: File, fd: int) -> int:
        """dup2 semantics: place a reference at a specific (free) slot."""
        assert fd not in self._files
        self._files[fd] = file
        file.refcount += 1
        return fd

    def remove(self, fd: int) -> Optional[File]:
        """Drop one descriptor; returns the file if that was the last ref."""
        f = self._files.pop(fd, None)
        if f is None:
            return None
        f.refcount -= 1
        return f if f.refcount == 0 else None

    def fds(self) -> "list[int]":
        return sorted(self._files)


# --------------------------------------------------------------------------
# Pipes (reference: descriptor/pipe.rs over shared_buf.rs)


class PipeBuf:
    CAPACITY = 65536

    def __init__(self):
        self.data = bytearray()
        self.read_open = True
        self.write_open = True


class PipeEnd(File):
    def __init__(self, buf: PipeBuf, is_read: bool, peer_notify):
        super().__init__()
        self.buf = buf
        self.is_read = is_read
        self._peer_notify = peer_notify  # notify the other end's listeners

    def readable(self) -> bool:
        return self.is_read and (len(self.buf.data) > 0 or not self.buf.write_open)

    def writable(self) -> bool:
        return (not self.is_read) and self.buf.read_open and len(
            self.buf.data
        ) < PipeBuf.CAPACITY

    def hup(self) -> bool:
        if self.is_read:
            return not self.buf.write_open and len(self.buf.data) == 0
        return not self.buf.read_open

    def read(self, n: int) -> "bytes | int":
        if not self.is_read:
            return -EBADF
        if self.buf.data:
            out = bytes(self.buf.data[:n])
            del self.buf.data[:n]
            self._peer_notify()  # writer may now have space
            return out
        if not self.buf.write_open:
            return b""  # EOF
        return -EAGAIN

    def write(self, data: bytes) -> int:
        if self.is_read:
            return -EBADF
        if not self.buf.read_open:
            return -EPIPE
        space = PipeBuf.CAPACITY - len(self.buf.data)
        if space <= 0:
            return -EAGAIN
        take = data[:space]
        self.buf.data.extend(take)
        self._peer_notify()  # reader has data
        return len(take)

    def on_close(self, kernel, proc) -> None:
        if self.is_read:
            self.buf.read_open = False
        else:
            self.buf.write_open = False
        self._peer_notify()
        super().on_close(kernel, proc)


def make_pipe() -> "tuple[PipeEnd, PipeEnd]":
    buf = PipeBuf()
    # each end notifies the *other* end's listeners on state change
    r = PipeEnd(buf, True, lambda: w.notify())
    w = PipeEnd(buf, False, lambda: r.notify())
    return r, w


# --------------------------------------------------------------------------
# EventFd (reference: descriptor/eventfd.rs)

EFD_SEMAPHORE = 1


class EventFd(File):
    MAX = (1 << 64) - 2

    def __init__(self, initval: int, flags: int):
        super().__init__()
        self.counter = initval
        self.semaphore = bool(flags & EFD_SEMAPHORE)

    def readable(self) -> bool:
        return self.counter > 0

    def writable(self) -> bool:
        return self.counter < self.MAX

    def read(self, n: int) -> "bytes | int":
        if n < 8:
            return -EINVAL
        if self.counter == 0:
            return -EAGAIN
        val = 1 if self.semaphore else self.counter
        self.counter -= val
        self.notify()
        return val.to_bytes(8, "little")

    def write(self, data: bytes) -> int:
        if len(data) < 8:
            return -EINVAL
        val = int.from_bytes(data[:8], "little")
        if val >= (1 << 64) - 1:
            return -EINVAL
        if self.counter + val > self.MAX:
            return -EAGAIN
        self.counter += val
        self.notify()
        return 8


# --------------------------------------------------------------------------
# TimerFd (reference: descriptor/timerfd.rs). Expirations are computed
# lazily from sim time; a kernel event at the next expiry fires notify()
# so poll/epoll and blocked reads wake deterministically.

TFD_TIMER_ABSTIME = 1


class TimerFd(File):
    def __init__(self, kernel):
        super().__init__()
        self.kernel = kernel
        self.next_expiry: Optional[int] = None  # ns sim time
        self.interval: int = 0
        self._gen = 0  # invalidates stale scheduled wakeups

    def _expirations(self, now: int) -> int:
        if self.next_expiry is None or now < self.next_expiry:
            return 0
        if self.interval == 0:
            return 1
        return 1 + (now - self.next_expiry) // self.interval

    def readable(self) -> bool:
        return self._expirations(self.kernel.now) > 0

    def settime(self, value_ns: int, interval_ns: int, flags: int) -> "tuple[int, int]":
        now = self.kernel.now
        old = self.gettime()
        self._gen += 1
        if value_ns == 0:
            self.next_expiry = None
            self.interval = 0
        else:
            self.next_expiry = value_ns if (flags & TFD_TIMER_ABSTIME) else now + value_ns
            self.interval = interval_ns
            self._schedule()
        return old

    def gettime(self) -> "tuple[int, int]":
        """(remaining_ns, interval_ns), with expirations folded forward."""
        now = self.kernel.now
        if self.next_expiry is None:
            return (0, self.interval)
        if now < self.next_expiry:
            return (self.next_expiry - now, self.interval)
        if self.interval == 0:
            return (0, 0)
        k = 1 + (now - self.next_expiry) // self.interval
        return (self.next_expiry + k * self.interval - now, self.interval)

    def _schedule(self) -> None:
        gen = self._gen
        exp = self.next_expiry
        if exp is None:
            return
        self.kernel._push(max(exp, self.kernel.now), lambda: self._fire(gen))

    def _fire(self, gen: int) -> None:
        if gen != self._gen or self.closed:
            return
        self.notify()

    def read(self, n: int) -> "bytes | int":
        if n < 8:
            return -EINVAL
        now = self.kernel.now
        k = self._expirations(now)
        if k == 0:
            return -EAGAIN
        if self.interval == 0:
            self.next_expiry = None
        else:
            self.next_expiry += k * self.interval
            self._gen += 1
            self._schedule()
        return k.to_bytes(8, "little")


# --------------------------------------------------------------------------
# Epoll (reference: descriptor/epoll.c:103-320). Level-triggered readiness
# recomputed on demand; EPOLLET arms on state-change notifications from the
# watched file's StateEventSource; EPOLLONESHOT disables after report.


@dataclasses.dataclass
class EpollWatch:
    file: File
    events: int
    data: int
    armed: bool = True  # ET: a state change happened since last report
    enabled: bool = True  # ONESHOT disarm


class Epoll(File):
    def __init__(self):
        super().__init__()
        self.watches: dict[int, EpollWatch] = {}  # keyed by watched fd

    def readable(self) -> bool:
        return len(self.ready()) > 0

    def _on_file_notify(self, fd: int):
        def cb(_file: File) -> None:
            w = self.watches.get(fd)
            if w is not None:
                w.armed = True
                self.notify()  # nested-epoll + waiters on the epfd

        return cb

    def ctl(self, op: int, fd: int, file: Optional[File], events: int, data: int) -> int:
        if op == EPOLL_CTL_ADD:
            if fd in self.watches:
                return -EEXIST
            if file is None:
                return -EBADF
            if file is self:
                return -EINVAL
            w = EpollWatch(file=file, events=events, data=data)
            self.watches[fd] = w
            cb = self._on_file_notify(fd)
            w._cb = cb  # type: ignore[attr-defined]
            file.add_listener(cb)
            return 0
        if op == EPOLL_CTL_DEL:
            w = self.watches.pop(fd, None)
            if w is None:
                return -ENOENT
            w.file.remove_listener(w._cb)  # type: ignore[attr-defined]
            return 0
        if op == EPOLL_CTL_MOD:
            w = self.watches.get(fd)
            if w is None:
                return -ENOENT
            w.events = events
            w.data = data
            w.armed = True
            w.enabled = True
            return 0
        return -EINVAL

    def ready(self) -> "list[tuple[int, int]]":
        """(revents, data) for every currently-ready watch, in fd order
        (sorted for determinism — the reference notes wanting exactly this,
        epoll.c:274-277)."""
        out = []
        for fd in sorted(self.watches):
            w = self.watches[fd]
            if not w.enabled:
                continue
            mask = w.file.poll_mask()
            hits = mask & (w.events | EPOLLERR | EPOLLHUP)  # ERR/HUP always on
            if not hits:
                continue
            if (w.events & EPOLLET) and not w.armed:
                continue
            out.append((fd, hits))
        return out

    def report(self, maxevents: int) -> "list[tuple[int, int]]":
        got = self.ready()[:maxevents]
        for fd, _ in got:
            w = self.watches[fd]
            if w.events & EPOLLET:
                w.armed = False
            if w.events & EPOLLONESHOT:
                w.enabled = False
        return [(self.watches[fd].data, hits) for fd, hits in got]

    def on_close(self, kernel, proc) -> None:
        for fd, w in list(self.watches.items()):
            w.file.remove_listener(w._cb)  # type: ignore[attr-defined]
        self.watches.clear()
        super().on_close(kernel, proc)


# --------------------------------------------------------------------------
# Deterministic random device (reference: regular_file.c special-cases
# /dev/random + /dev/urandom so guests draw from the host RNG stream, not
# the real kernel's)


class RandomFile(File):
    def __init__(self, draw: "Callable[[int], bytes]"):
        super().__init__()
        self._draw = draw

    def readable(self) -> bool:
        return True

    def writable(self) -> bool:
        return True

    def read(self, n: int) -> "bytes | int":
        return self._draw(n)

    def write(self, data: bytes) -> int:
        return len(data)  # writes to /dev/urandom are accepted and ignored


# --------------------------------------------------------------------------
# Unix-domain sockets (reference: descriptor/socket/unix.rs, 2,269 LoC —
# stream + dgram incl. the abstract namespace, abstract_unix_ns.rs).
# Host-local by construction: addresses live in a per-host namespace map
# keyed (abstract, path); filesystem socket inodes are not materialized in
# the sandbox dir (connect() resolves purely through the namespace map).

SOCK_STREAM = 1
SOCK_DGRAM = 2


class UnixSocket(File):
    CAPACITY = 212992  # per-direction buffer, net.core.wmem_default-ish
    DGRAM_QUEUE = 64  # max queued datagrams per receiver

    def __init__(self, stype: int):
        super().__init__()
        self.stype = stype
        self.bound: "Optional[tuple[bool, str]]" = None  # (abstract, path)
        # stream state
        self.listening = False
        self.backlog = 0
        self.pending: "deque[UnixSocket]" = deque()  # children awaiting accept
        self.peer: "Optional[UnixSocket]" = None
        self.recv_buf = bytearray()
        self.peer_closed = False
        self.shut_wr = False
        # dgram state: queue of ((abstract, path) | None, payload)
        self.dgrams: "deque[tuple[Optional[tuple[bool, str]], bytes]]" = deque()
        self.default_dest: "Optional[UnixSocket]" = None

    # --- poll interface ---------------------------------------------------

    def readable(self) -> bool:
        if self.listening:
            return len(self.pending) > 0
        if self.stype == SOCK_DGRAM:
            return len(self.dgrams) > 0
        return len(self.recv_buf) > 0 or self.peer_closed

    def writable(self) -> bool:
        if self.listening:
            return False
        if self.stype == SOCK_DGRAM:
            return True  # bounded only by the receiver's queue at send time
        return (
            self.peer is not None
            and not self.peer_closed
            and not self.shut_wr
            and len(self.peer.recv_buf) < self.CAPACITY
        )

    def hup(self) -> bool:
        return self.stype == SOCK_STREAM and self.peer_closed and not self.recv_buf

    # --- stream ops -------------------------------------------------------

    def stream_send(self, data: bytes) -> int:
        if self.peer_closed or self.shut_wr:
            return -EPIPE  # peer closed: EPIPE even though peer ref is gone
        if self.peer is None:
            return -ENOTCONN
        space = self.CAPACITY - len(self.peer.recv_buf)
        if space <= 0:
            return -EAGAIN
        take = data[:space]
        self.peer.recv_buf.extend(take)
        self.peer.notify()
        return len(take)

    def stream_peek(self, n: int) -> "bytes | int":
        """MSG_PEEK: read without consuming."""
        if self.peer is None and not self.peer_closed:
            return -ENOTCONN
        if self.recv_buf:
            return bytes(self.recv_buf[:n])
        if self.peer_closed:
            return b""
        return -EAGAIN

    def stream_recv(self, n: int) -> "bytes | int":
        if self.peer is None and not self.peer_closed:
            return -ENOTCONN
        if self.recv_buf:
            out = bytes(self.recv_buf[:n])
            del self.recv_buf[:n]
            if self.peer is not None:
                self.peer.notify()  # writer may have space again
            return out
        if self.peer_closed:
            return b""  # EOF
        return -EAGAIN

    # --- dgram ops --------------------------------------------------------

    def dgram_send_to(self, dest: "UnixSocket", data: bytes) -> int:
        if dest.closed:
            return -ECONNREFUSED  # e.g. the other socketpair end was closed
        if len(dest.dgrams) >= self.DGRAM_QUEUE:
            return -EAGAIN
        dest.dgrams.append((self.bound, bytes(data)))
        dest.notify()
        return len(data)

    def dgram_recv(self) -> "Optional[tuple[Optional[tuple[bool, str]], bytes]]":
        if not self.dgrams:
            return None
        d = self.dgrams.popleft()
        self.notify()  # senders blocked on a full queue re-check
        return d

    # --- lifecycle --------------------------------------------------------

    def connect_to_listener(self, listener: "UnixSocket") -> "int | UnixSocket":
        """Stream connect: create the server-side child and queue it for
        accept (unix.rs connect path). Returns the child, or -errno."""
        if len(listener.pending) >= max(listener.backlog, 1):
            return -EAGAIN
        child = UnixSocket(SOCK_STREAM)
        child.bound = listener.bound
        child.peer = self
        self.peer = child
        listener.pending.append(child)
        listener.notify()
        return child

    def shutdown_write(self) -> int:
        if self.stype != SOCK_STREAM or (self.peer is None and not self.peer_closed):
            return -ENOTCONN
        self.shut_wr = True
        if self.peer is not None:
            self.peer.peer_closed = True
            self.peer.notify()
        return 0

    def on_close(self, kernel, proc) -> None:
        if self.peer is not None:
            self.peer.peer_closed = True
            self.peer.notify()
            self.peer.peer = None
            self.peer = None
        for child in self.pending:  # un-accepted connections are reset
            if child.peer is not None:
                child.peer.peer_closed = True
                child.peer.notify()
                child.peer.peer = None
        self.pending.clear()
        super().on_close(kernel, proc)


# --------------------------------------------------------------------------
# UDP socket (moved from kernel.py; reference: descriptor/socket/inet/udp.rs)


class UdpSocket(File):
    RECV_CAPACITY = 131072  # bytes of queued datagrams before drop

    def __init__(self):
        super().__init__()
        self.bound_port = 0  # 0 = unbound
        self.peer: Optional[tuple[int, int]] = None  # (ip, port) after connect
        self.recvq: deque = deque()  # (data, ip, port)
        self.recvq_bytes = 0

    def readable(self) -> bool:
        return len(self.recvq) > 0

    def writable(self) -> bool:
        return True  # sends never block in the UDP model

    def deliver(self, data: bytes, src_ip: int, src_port: int) -> bool:
        if self.recvq_bytes + len(data) > self.RECV_CAPACITY:
            return False  # full receive buffer: drop, like a real UDP rmem
        self.recvq.append((data, src_ip, src_port))
        self.recvq_bytes += len(data)
        self.notify()
        return True

    def take(self) -> "tuple[bytes, int, int]":
        data, ip, port = self.recvq.popleft()
        self.recvq_bytes -= len(data)
        return data, ip, port
