"""Simulation-aware logging.

The reference's ShadowLogger stamps every record with wall time, emulated
time, and the active host, queues records, and flushes them from a
dedicated thread so the simulation loop never blocks on IO, with a
panic-flush hook (reference: src/main/core/logger/shadow_logger.rs:33-47).
Same structure here: records go to a queue drained by a daemon flush
thread; `flush()` drains synchronously and is registered via atexit and
called by error-level records (the panic-flush analogue). Record shape:

  00:00:01.234 [info] [2000-01-01 00:00:05.000000000] [hostname] message
"""

from __future__ import annotations

import atexit
import queue
import sys
import threading
import time

from shadow_tpu_torch.simtime import fmt_time_ns

_LEVELS = {"error": 40, "warning": 30, "info": 20, "debug": 10, "trace": 5}
_threshold = 20
_start = time.monotonic()
_sink = None  # None = stderr

_queue: "queue.SimpleQueue[str | None]" = queue.SimpleQueue()
_flusher: "threading.Thread | None" = None
_idle = threading.Event()
_idle.set()
_sync = False  # interactive runs (progress line) need a single writer


def set_level(level: str) -> None:
    global _threshold
    _threshold = _LEVELS.get(level, 20)


def set_sync(sync: bool) -> None:
    """Synchronous mode: every record drains before slog returns. Used
    when the \r progress status line shares stderr — two writer threads
    would interleave (the reference's status bar owns the terminal the
    same way)."""
    global _sync
    _sync = sync


def set_sink(fileobj) -> None:
    """Redirect records (None restores stderr). Flushes first so earlier
    records land in the earlier sink."""
    global _sink
    flush()
    _sink = fileobj


def _flush_loop() -> None:
    while True:
        line = _queue.get()
        out = _sink or sys.stderr
        if line is None:
            out.flush()  # a flush() request must reach the OS, not a buffer
            _idle.set()
            continue
        _idle.clear()
        print(line, file=out, flush=_queue.empty())
        if _queue.empty():
            _idle.set()


def _ensure_flusher() -> None:
    global _flusher
    if _flusher is None or not _flusher.is_alive():
        _flusher = threading.Thread(target=_flush_loop, name="shadow-log", daemon=True)
        _flusher.start()
        atexit.register(flush)


def flush(timeout_s: float = 5.0) -> None:
    """Drain queued records (the reference's panic-flush / shutdown sync)."""
    if _flusher is None or not _flusher.is_alive():
        return
    _queue.put(None)  # wake the flusher even when idle
    deadline = time.monotonic() + timeout_s
    while not _queue.empty() and time.monotonic() < deadline:
        time.sleep(0.001)
    _idle.wait(timeout=max(0.0, deadline - time.monotonic()))


def slog(level: str, sim_time_ns: int, host: str, msg: str) -> None:
    if _LEVELS.get(level, 20) < _threshold:
        return
    elapsed = time.monotonic() - _start
    mm, ss = divmod(elapsed, 60)
    hh, mm = divmod(int(mm), 60)
    line = (
        f"{hh:02d}:{int(mm):02d}:{ss:06.3f} [{level}] "
        f"[{fmt_time_ns(sim_time_ns)}] [{host}] {msg}"
    )
    _ensure_flusher()
    _queue.put(line)
    if _sync or _LEVELS.get(level, 20) >= 40:
        flush()  # interactive single-writer mode / crash-proof errors
