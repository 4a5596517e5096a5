"""Per-process strace-style syscall logging
(port of shadow_tpu/hostk/strace.py).

Rebuilds the reference's strace subsystem (reference: the #[log_syscall]
proc-macro src/lib/syscall-logger/src/lib.rs:1-30, the formatter
src/main/host/syscall/formatter.rs, and StraceFmtMode {Off, Standard,
Deterministic} configuration.rs:1120). Lines are written per process to
`<data-dir>/<hostname>/<exe>.<vpid>.strace`.

Deterministic mode omits emulated-time timestamps so two runs diff clean
even across schedulers with different time quantization; standard mode
prefixes each line with the emulated time, like the reference.
"""

from __future__ import annotations

import pathlib
from typing import Optional


def fmt_emulated(ns: int) -> str:
    s, rem = divmod(ns, 1_000_000_000)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    return f"{h:02d}:{m:02d}:{s:02d}.{rem:09d}"


class StraceFile:
    def __init__(self, path: str | pathlib.Path, vpid: int, mode: str = "standard"):
        assert mode in ("off", "standard", "deterministic")
        self.mode = mode
        self.vpid = vpid
        self._f = None
        if mode != "off":
            pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
            # line-buffered like real strace: a hung guest's trace shows
            # exactly how far it got
            self._f = open(path, "w", buffering=1)

    def log(
        self, now_ns: int, name: str, args: str, ret: "int | str", tid: "Optional[int]" = None
    ) -> None:
        if self._f is None:
            return
        prefix = "" if self.mode == "deterministic" else f"{fmt_emulated(now_ns)} "
        if isinstance(ret, int) and ret < 0:
            rs = f"{ret} ({_errno_name(-ret)})"
        else:
            rs = str(ret)
        self._f.write(f"{prefix}[tid {tid if tid is not None else self.vpid}] {name}({args}) = {rs}\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


_ERRNO = {
    1: "EPERM", 2: "ENOENT", 9: "EBADF", 11: "EAGAIN", 17: "EEXIST",
    22: "EINVAL", 32: "EPIPE", 38: "ENOSYS", 88: "ENOTSOCK", 89: "EDESTADDRREQ",
    90: "EMSGSIZE", 98: "EADDRINUSE", 104: "ECONNRESET", 106: "EISCONN",
    107: "ENOTCONN", 110: "ETIMEDOUT", 111: "ECONNREFUSED", 115: "EINPROGRESS",
}


def _errno_name(e: int) -> str:
    return _ERRNO.get(e, f"errno {e}")
