"""Independent scalar shaping references for the conformance oracle (port
of shadow_tpu/cpu_ref/netstack_ref.py).

These re-implement the token-bucket relay and CoDel AQM directly from the
reference's specification (reference: src/main/network/relay/mod.rs:50-318,
src/main/network/relay/token_bucket.rs:69-120,
src/main/network/router/codel_queue.rs:23-540) in plain Python integers.

Deliberately nothing here is imported from `shadow_tpu_torch.netstack` —
not the constants, not the control-law table, not the closed forms. The
oracle's whole value is that a systematic error in the engine's
arithmetic cannot propagate into the checker; equality between this
module and the device engine is asserted by tests, never assumed by
imports.
"""

from __future__ import annotations

import math

# Restated from the reference spec: the relay refills every 1 ms
# (relay/mod.rs:286) with an MTU burst allowance (relay/mod.rs:277-284);
# CoDel uses TARGET 10 ms / INTERVAL 100 ms (codel_queue.rs:23-34).
REFILL_INTERVAL_NS = 1_000_000
CODEL_TARGET_NS = 10_000_000
CODEL_INTERVAL_NS = 100_000_000
MTU_BYTES = 1500

# The engine clamps the control-law divisor index at 1024 (decay beyond is
# negligible); same clamp here, computed per call instead of via a table.
_CODEL_COUNT_CLAMP = 1024


def codel_control_law_ref(count: int) -> int:
    """interval / sqrt(count) in ns (RFC 8289 §4.2), IEEE-double sqrt then
    truncation — the same rounding the engine's precomputed table uses."""
    c = min(max(int(count), 1), _CODEL_COUNT_CLAMP)
    return int(CODEL_INTERVAL_NS / math.sqrt(c))


class TokenBucketRef:
    """Integer conforming-remove token bucket for one host direction.

    refill <= 0 means unlimited (packets depart immediately). Buckets
    refill `refill` bytes at fixed 1 ms boundaries anchored at `last`,
    capped at refill + MTU while idle; `depart(now, size)` returns the
    earliest time >= now the bucket can serve `size` bytes and charges it.
    """

    __slots__ = ("refill", "tokens", "last")

    def __init__(self, refill: int):
        self.refill = int(refill)
        self.tokens = int(refill) + MTU_BYTES
        self.last = 0

    def depart(self, now: int, size: int) -> int:
        if self.refill <= 0:
            return now
        cap = self.refill + MTU_BYTES
        intervals = max(now - self.last, 0) // REFILL_INTERVAL_NS
        cur = min(cap, self.tokens + intervals * self.refill)
        cur_last = self.last + intervals * REFILL_INTERVAL_NS
        deficit = max(size - cur, 0)
        k = (deficit + self.refill - 1) // self.refill
        if deficit > 0:
            depart = cur_last + k * REFILL_INTERVAL_NS
            self.last = depart
        else:
            depart = now
            self.last = cur_last
        self.tokens = cur + k * self.refill - size
        return depart


class CoDelRef:
    """One host's CoDel dropper, advanced once per dequeue (RFC 8289)."""

    __slots__ = ("first_above", "drop_next", "count", "dropping")

    def __init__(self):
        self.first_above = -1
        self.drop_next = 0
        self.count = 0
        self.dropping = False

    def dequeue(self, now: int, sojourn: int, backlog_bytes: int) -> bool:
        below = sojourn < CODEL_TARGET_NS or backlog_bytes < MTU_BYTES
        ok_to_drop = False
        if below:
            self.first_above = -1
        elif self.first_above < 0:
            self.first_above = now + CODEL_INTERVAL_NS
        elif now >= self.first_above:
            ok_to_drop = True

        if self.dropping:
            if not ok_to_drop:
                self.dropping = False
                return False
            if now >= self.drop_next:
                self.count += 1
                self.drop_next += codel_control_law_ref(self.count)
                return True
            return False
        if ok_to_drop:
            self.dropping = True
            recent = (now - self.drop_next) < CODEL_INTERVAL_NS
            self.count = self.count - 2 if (recent and self.count > 2) else 1
            self.drop_next = now + codel_control_law_ref(self.count)
            return True
        return False
