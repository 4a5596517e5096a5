"""ctypes bindings over native/shim: shmem blocks + futex channels
(port of shadow_tpu/hostk/ipc.py).

Host side of the IPC substrate (reference: src/lib/shmem/src/allocator.rs
block management + src/lib/vasi-sync/src/scchannel.rs; the serialized
block handle passed through the environment mirrors SHADOW_IPC_BLK,
managed_thread.rs:94-102 — here it is simply the shm file path in
SHADOW_SHM)."""

from __future__ import annotations

import ctypes
import mmap
import os
import pathlib
import tempfile

from shadow_tpu_torch.hostk.build import host_lib_path

SHIM_BUF_SIZE = 65536

# message kinds (native/shim/shadow_ipc.h)
MSG_START_REQ = 1
MSG_START_RES = 2
MSG_SYSCALL = 3
MSG_SYSCALL_DONE = 4
MSG_PROC_EXIT = 5

# virtual syscall codes (mirrors native/shim/shadow_ipc.h)
VSYS_NANOSLEEP = 1
VSYS_SOCKET = 2
VSYS_BIND = 3
VSYS_SENDTO = 4
VSYS_RECVFROM = 5
VSYS_CLOSE = 6
VSYS_GETPID = 7
VSYS_CONNECT = 8
VSYS_GETSOCKNAME = 9
VSYS_YIELD = 10
VSYS_EXIT = 11
VSYS_CLOCK_GETTIME = 12
VSYS_LISTEN = 13
VSYS_ACCEPT = 14
VSYS_SHUTDOWN = 15
VSYS_GETPEERNAME = 16
VSYS_SETSOCKOPT = 17
VSYS_GETSOCKOPT = 18
VSYS_FCNTL = 19
VSYS_IOCTL = 20
VSYS_PIPE2 = 21
VSYS_READ = 22
VSYS_WRITE = 23
VSYS_EVENTFD = 24
VSYS_TIMERFD_CREATE = 25
VSYS_TIMERFD_SETTIME = 26
VSYS_TIMERFD_GETTIME = 27
VSYS_EPOLL_CREATE = 28
VSYS_EPOLL_CTL = 29
VSYS_EPOLL_WAIT = 30
VSYS_POLL = 31
VSYS_GETHOSTNAME = 32
VSYS_UNAME = 33
VSYS_RESOLVE = 34
VSYS_GETRANDOM = 35
VSYS_DUP = 36
VSYS_OPEN = 37
VSYS_UBIND = 38
VSYS_UCONNECT = 39
VSYS_USENDTO = 40
VSYS_SOCKETPAIR = 41
VSYS_SIGACTION = 42
VSYS_ALARM = 43
VSYS_SETITIMER = 44
VSYS_GETITIMER = 45
VSYS_KILL = 46
VSYS_PAUSE = 47
VSYS_RESOLVE_REV = 48
VSYS_DUP2 = 49
VSYS_FSTAT = 50
VSYS_THREAD_CREATE = 51
VSYS_THREAD_EXIT = 52
VSYS_THREAD_JOIN = 53
VSYS_THREAD_FAILED = 54
VSYS_MUTEX_LOCK = 55
VSYS_MUTEX_TRYLOCK = 56
VSYS_MUTEX_UNLOCK = 57
VSYS_COND_WAIT = 58
VSYS_COND_SIGNAL = 59
VSYS_FORK = 60
VSYS_WAITPID = 61
VSYS_FUTEX_WAIT = 62
VSYS_FUTEX_WAKE = 63
VSYS_FUTEX_REQUEUE = 64
VSYS_SIGMASK = 65
VSYS_MM_NOTE = 66  # a[1]=op(1 mmap,2 munmap,3 brk,4 mremap) a[2]=addr a[3]=len, buf=[prot,flags,fd,off] i64
VSYS_FD_NATIVE = 67  # a[1]=op(1 opened, 2 closed) a[2]=native fd
VSYS_WRITE_BULK = 68  # a[1]=fd a[2]=guest addr a[3]=len a[5]=dontwait
VSYS_READ_BULK = 69  # a[1]=fd a[2]=guest addr a[3]=len a[5]=dontwait

# message kind for a new thread announcing itself on its own channel
MSG_THREAD_START = 6
MSG_CHILD_START = 7  # forked child announcing on its own channel

VSYS_NAMES = {
    VSYS_NANOSLEEP: "nanosleep",
    VSYS_SOCKET: "socket",
    VSYS_BIND: "bind",
    VSYS_SENDTO: "sendto",
    VSYS_RECVFROM: "recvfrom",
    VSYS_CLOSE: "close",
    VSYS_GETPID: "getpid",
    VSYS_CONNECT: "connect",
    VSYS_GETSOCKNAME: "getsockname",
    VSYS_YIELD: "yield",
    VSYS_EXIT: "exit_group",  # process exit, as in real strace output
    VSYS_CLOCK_GETTIME: "clock_gettime",
    VSYS_LISTEN: "listen",
    VSYS_ACCEPT: "accept",
    VSYS_SHUTDOWN: "shutdown",
    VSYS_GETPEERNAME: "getpeername",
    VSYS_SETSOCKOPT: "setsockopt",
    VSYS_GETSOCKOPT: "getsockopt",
    VSYS_FCNTL: "fcntl",
    VSYS_IOCTL: "ioctl",
    VSYS_PIPE2: "pipe2",
    VSYS_READ: "read",
    VSYS_WRITE: "write",
    VSYS_EVENTFD: "eventfd2",
    VSYS_TIMERFD_CREATE: "timerfd_create",
    VSYS_TIMERFD_SETTIME: "timerfd_settime",
    VSYS_TIMERFD_GETTIME: "timerfd_gettime",
    VSYS_EPOLL_CREATE: "epoll_create1",
    VSYS_EPOLL_CTL: "epoll_ctl",
    VSYS_EPOLL_WAIT: "epoll_wait",
    VSYS_POLL: "poll",
    VSYS_GETHOSTNAME: "gethostname",
    VSYS_UNAME: "uname",
    VSYS_RESOLVE: "getaddrinfo",
    VSYS_GETRANDOM: "getrandom",
    VSYS_DUP: "dup",
    VSYS_OPEN: "open",
    VSYS_UBIND: "bind",  # unix-domain variants share the libc name in straces
    VSYS_UCONNECT: "connect",
    VSYS_USENDTO: "sendto",
    VSYS_SOCKETPAIR: "socketpair",
    VSYS_SIGACTION: "rt_sigaction",
    VSYS_ALARM: "alarm",
    VSYS_SETITIMER: "setitimer",
    VSYS_GETITIMER: "getitimer",
    VSYS_KILL: "kill",
    VSYS_PAUSE: "pause",
    VSYS_RESOLVE_REV: "getnameinfo",
    VSYS_DUP2: "dup2",
    VSYS_FSTAT: "fstat",
    VSYS_THREAD_CREATE: "clone",  # libc-visible names for strace parity
    VSYS_THREAD_EXIT: "exit",
    VSYS_THREAD_JOIN: "pthread_join",
    VSYS_THREAD_FAILED: "clone_failed",
    VSYS_MUTEX_LOCK: "futex_lock",
    VSYS_MUTEX_TRYLOCK: "futex_trylock",
    VSYS_MUTEX_UNLOCK: "futex_unlock",
    VSYS_COND_WAIT: "futex_wait",
    VSYS_COND_SIGNAL: "futex_wake",
    VSYS_FORK: "fork",
    VSYS_WAITPID: "wait4",
    # raw SYS_futex emulation: real strace shows one name for all ops
    VSYS_FUTEX_WAIT: "futex",
    VSYS_FUTEX_WAKE: "futex",
    VSYS_FUTEX_REQUEUE: "futex",
    VSYS_SIGMASK: "rt_sigprocmask",
    VSYS_MM_NOTE: "mmap",
    VSYS_FD_NATIVE: "fd_native",
    VSYS_WRITE_BULK: "write",
    VSYS_READ_BULK: "read",
}


class ShimMsg(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_uint32),
        ("tid", ctypes.c_uint32),
        ("a", ctypes.c_int64 * 6),
        ("ret", ctypes.c_int64),
        ("buf_len", ctypes.c_uint32),
        ("sig", ctypes.c_uint32),  # shadow->shim: deliver before returning
        ("buf", ctypes.c_char * SHIM_BUF_SIZE),
    ]


class _Lib:
    _instance = None

    def __init__(self):
        lib = ctypes.CDLL(host_lib_path())
        lib.shim_channel_send.argtypes = [ctypes.c_void_p, ctypes.POINTER(ShimMsg)]
        lib.shim_channel_send.restype = None
        lib.shim_channel_recv.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ShimMsg),
            ctypes.c_int,
        ]
        lib.shim_channel_recv.restype = ctypes.c_int
        lib.shim_channel_poll.argtypes = [ctypes.c_void_p]
        lib.shim_channel_poll.restype = ctypes.c_int
        lib.shim_shmem_init.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int64,
        ]
        lib.shim_shmem_init.restype = None
        lib.shim_set_time.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.shim_set_time.restype = None
        lib.shim_get_time.argtypes = [ctypes.c_void_p]
        lib.shim_get_time.restype = ctypes.c_int64
        for f in (
            lib.shim_layout_size,
            lib.shim_layout_to_shadow,
            lib.shim_layout_to_shim,
            lib.shim_layout_msg_size,
        ):
            f.argtypes = []
            f.restype = ctypes.c_int
        self.lib = lib

    @classmethod
    def get(cls):
        if cls._instance is None:
            cls._instance = _Lib()
        return cls._instance


def _layout():
    """Struct offsets exported by the C library (never duplicated here)."""
    lib = _Lib.get().lib
    assert lib.shim_layout_msg_size() == ctypes.sizeof(ShimMsg), (
        "ShimMsg ctypes mirror out of sync with shadow_ipc.h"
    )
    return (
        lib.shim_layout_size(),
        lib.shim_layout_to_shadow(),
        lib.shim_layout_to_shim(),
    )


class IpcBlock:
    """One managed process's shared block + its two channels."""

    def __init__(
        self,
        tag: str,
        vdso_latency_ns: int = 10,
        syscall_latency_ns: int = 1_000,
        max_unapplied_ns: int = 1_000_000,
        dir: str | None = None,
    ):
        size, self._to_shadow_off, self._to_shim_off = _layout()
        base = pathlib.Path(dir or "/dev/shm")
        fd, path = tempfile.mkstemp(prefix=f"shadow-tpu-{tag}-", dir=str(base))
        os.ftruncate(fd, size)
        self.path = path
        self._mm = mmap.mmap(fd, size)
        os.close(fd)
        self._addr = ctypes.addressof(ctypes.c_char.from_buffer(self._mm))
        self._lib = _Lib.get().lib
        self._lib.shim_shmem_init(
            self._addr, vdso_latency_ns, syscall_latency_ns, max_unapplied_ns
        )

    # channels
    def send_to_shim(self, msg: ShimMsg) -> None:
        self._lib.shim_channel_send(self._addr + self._to_shim_off, ctypes.byref(msg))

    def recv_from_shim(self, timeout_ms: int = -1) -> ShimMsg | None:
        out = ShimMsg()
        r = self._lib.shim_channel_recv(
            self._addr + self._to_shadow_off, ctypes.byref(out), timeout_ms
        )
        return out if r == 0 else None

    def poll_from_shim(self) -> bool:
        return bool(self._lib.shim_channel_poll(self._addr + self._to_shadow_off))

    def set_time(self, now_ns: int, max_runahead_ns: int) -> None:
        self._lib.shim_set_time(self._addr, now_ns, max_runahead_ns)

    def close(self) -> None:
        if self._mm is not None:
            del self._addr
            self._mm.close()
            self._mm = None
        try:
            os.unlink(self.path)
        except OSError:
            pass


_BUF_OFFSET = ShimMsg.buf.offset


def msg_payload(m: ShimMsg) -> bytes:
    """The message's buf as raw bytes. (A c_char array *field* has value
    semantics in ctypes — it copies and truncates at NUL — so payload
    access must go through the struct's address.)"""
    return ctypes.string_at(ctypes.addressof(m) + _BUF_OFFSET, m.buf_len)


def make_msg(kind: int, a=(), ret: int = 0, buf: bytes = b"") -> ShimMsg:
    m = ShimMsg()
    m.kind = kind
    for i, v in enumerate(a):
        m.a[i] = int(v)
    m.ret = ret
    if buf:
        m.buf_len = len(buf)
        ctypes.memmove(ctypes.addressof(m) + _BUF_OFFSET, buf, len(buf))
    return m
