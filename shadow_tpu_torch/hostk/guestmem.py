"""Direct guest-memory access: the bulk tier of the memory manager
(port of shadow_tpu/hostk/guestmem.py).

The reference's MemoryCopier reads/writes plugin memory with
process_vm_readv/writev (reference:
src/main/host/memory_manager/memory_copier.rs:64-170) so payload bytes
never ride the IPC channel. Same here: the kernel (this process) copies
straight out of / into the frozen guest's address space — guests are
strictly serialized by the ping-pong channel discipline, so the pages
are stable for the duration of the copy.

Falls back cleanly: reader/writer return None/-1 on any failure (EPERM,
ESRCH, partial page faults), and the kernel then answers the shim with
-ENOSYS so IO retraces the chunked shm path.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_libc = ctypes.CDLL(None, use_errno=True)


class _IoVec(ctypes.Structure):
    _fields_ = [("iov_base", ctypes.c_void_p), ("iov_len", ctypes.c_size_t)]


try:
    _readv = _libc.process_vm_readv
    _writev = _libc.process_vm_writev
    for fn in (_readv, _writev):
        fn.restype = ctypes.c_ssize_t
        fn.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(_IoVec),
            ctypes.c_ulong,
            ctypes.POINTER(_IoVec),
            ctypes.c_ulong,
            ctypes.c_ulong,
        ]
    AVAILABLE = True
except AttributeError:  # pragma: no cover — ancient libc
    AVAILABLE = False


def read_guest(pid: int, addr: int, n: int) -> "bytes | None":
    """Read n bytes at `addr` in the guest; None on any failure."""
    if not AVAILABLE or pid is None or n < 0:
        return None
    if n == 0:
        return b""
    buf = ctypes.create_string_buffer(n)
    local = _IoVec(ctypes.cast(buf, ctypes.c_void_p), n)
    remote = _IoVec(ctypes.c_void_p(addr), n)
    got = _readv(pid, ctypes.byref(local), 1, ctypes.byref(remote), 1, 0)
    if got != n:
        return None
    return buf.raw


def write_guest(pid: int, addr: int, data: bytes) -> bool:
    """Write data at `addr` in the guest; False on any failure."""
    if not AVAILABLE or pid is None:
        return False
    if not data:
        return True
    buf = ctypes.create_string_buffer(data, len(data))
    local = _IoVec(ctypes.cast(buf, ctypes.c_void_p), len(data))
    remote = _IoVec(ctypes.c_void_p(addr), len(data))
    got = _writev(pid, ctypes.byref(local), 1, ctypes.byref(remote), 1, 0)
    return got == len(data)
