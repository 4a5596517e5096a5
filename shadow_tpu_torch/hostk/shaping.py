"""Scalar token-bucket + CoDel shaping for the managed-process tier
(port of shadow_tpu/hostk/shaping.py).

The serial CPU kernel shapes real guests' traffic with the same integer
closed forms as the device engine's vectorized netstack (netstack.py
tb_depart/codel_dequeue), one instance per host per direction — it must
stay bit-identical to the device tier because the hybrid scheduler checks
serial-vs-device conformance on exactly these timelines (reference
analogue: src/main/network/relay/mod.rs:50-318, router/codel_queue.rs).

(The conformance *oracle* has its own independent copies in
cpu_ref/netstack_ref.py — do not merge the two; see that module's
docstring.)
"""

from __future__ import annotations

from shadow_tpu_torch.netstack import (
    CODEL_INTERVAL_NS,
    CODEL_TARGET_NS,
    MTU_BYTES,
    REFILL_INTERVAL_NS,
    codel_control_law,
)


class TokenBucketRef:
    """Integer scalar of netstack.tb_depart for one host direction."""

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
    """Integer scalar of netstack.codel_dequeue for one host."""

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
                self.drop_next += codel_control_law(self.count)
                return True
            return False
        if ok_to_drop:
            self.dropping = True
            recent = (now - self.drop_next) < CODEL_INTERVAL_NS
            self.count = self.count - 2 if (recent and self.count > 2) else 1
            self.drop_next = now + codel_control_law(self.count)
            return True
        return False
