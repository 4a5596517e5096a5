"""Status line (reference: utility/status_bar.rs + the controller's
progress printer, controller.rs:42-51). One instance per run; both
schedulers and the managed kernel share it so format/throttle live in
one place. Regular log lines call clear() first so the \\r status line
never interleaves with them."""

from __future__ import annotations

import sys
import time


def _fmt_rate(x: float) -> str:
    if x >= 1e6:
        return f"{x / 1e6:.1f}M"
    if x >= 1e3:
        return f"{x / 1e3:.1f}k"
    return f"{x:.0f}"


class ProgressLine:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._last = 0.0
        # rate window: last rendered (wall, now_ns, events) sample — the
        # probe already carries event totals, so throughput costs no
        # extra device sync
        self._rate_ref: "tuple[float, int, int] | None" = None
        if enabled:
            # share stderr with the logger as a single writer: records
            # drain synchronously so clear() truly precedes them
            from shadow_tpu_torch.utils import shadow_log

            shadow_log.set_sync(True)

    def update(self, now_ns: int, end_ns: int, events: "int | None" = None) -> None:
        if not self.enabled:
            return
        w = time.monotonic()
        if w - self._last < 0.5:
            return
        self._last = w
        pct = min(100, now_ns * 100 // max(end_ns, 1))
        rates = ""
        if events is not None:
            if self._rate_ref is not None:
                w0, n0, e0 = self._rate_ref
                dw = w - w0
                if dw > 0:
                    rates = (
                        f" {_fmt_rate((events - e0) / dw)} ev/s"
                        f" {(now_ns - n0) / 1e9 / dw:.2f} sim-s/s"
                    )
            self._rate_ref = (w, now_ns, events)
        print(
            f"\r\x1b[Kprogress: {pct:3d}% (sim {now_ns / 1e9:.2f}s / {end_ns / 1e9:.2f}s)"
            f"{rates}",
            end="",
            file=sys.stderr,
            flush=True,
        )

    def clear(self) -> None:
        """Erase the status line before an ordinary log record."""
        if self.enabled:
            print("\r\x1b[K", end="", file=sys.stderr, flush=True)

    def finish(self, end_ns: int) -> None:
        if self.enabled:
            print(f"\r\x1b[Kprogress: 100% (sim {end_ns / 1e9:.2f}s)", file=sys.stderr)
