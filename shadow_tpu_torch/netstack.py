"""Vectorized per-host network device: token-bucket relays + CoDel AQM
(port of shadow_tpu/netstack.py).

The token bucket refills a fixed amount on a fixed 1 ms interval, so a
packet's departure time is closed-form integer arithmetic over the bucket
state; CoDel is a per-host scalar state machine advanced once per
dequeue, with interval / sqrt(count) read from a precomputed int64 table
so every backend agrees bit for bit. All bucket math is int64; the
divisions are floor divisions of non-negative values.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shadow_tpu_torch.simtime import NS_PER_MS

REFILL_INTERVAL_NS = 1 * NS_PER_MS
CODEL_TARGET_NS = 10 * NS_PER_MS
CODEL_INTERVAL_NS = 100 * NS_PER_MS
MTU_BYTES = 1500

AUX_SIZE_MASK = (1 << 24) - 1
AUX_SHAPED_BIT = 1 << 24

_CODEL_TABLE_LEN = 1024
_codel_div_np = np.array(
    [CODEL_INTERVAL_NS]
    + [
        int(CODEL_INTERVAL_NS / float(np.sqrt(np.float64(c))))
        for c in range(1, _CODEL_TABLE_LEN + 1)
    ],
    dtype=np.int64,
)


def codel_table(device="cpu") -> torch.Tensor:
    """The control-law table [1 + 1024] i64 (for kernel threading)."""
    return torch.as_tensor(_codel_div_np, device=device)


def codel_control_law(count, table=None):
    """interval / sqrt(count) in ns, table-driven (ints or tensors)."""
    if isinstance(count, torch.Tensor):
        if table is None:
            table = codel_table(count.device)
        idx = torch.clamp(count.to(torch.int64), 1, _CODEL_TABLE_LEN)
        return table[idx]
    return int(_codel_div_np[min(max(int(count), 1), _CODEL_TABLE_LEN)])


@dataclasses.dataclass
class NetDevState:
    """Per-host network-device state (all leaves lead with the host axis).
    A refill of 0 bytes/interval means unlimited."""

    tx_refill: torch.Tensor  # [H] i64 bytes per refill interval (0 = unlimited)
    tx_tokens: torch.Tensor  # [H] i64
    tx_last: torch.Tensor  # [H] i64 ns of last refill boundary
    rx_refill: torch.Tensor  # [H] i64
    rx_tokens: torch.Tensor  # [H] i64
    rx_last: torch.Tensor  # [H] i64
    codel_first_above: torch.Tensor  # [H] i64 ns; -1 = none
    codel_drop_next: torch.Tensor  # [H] i64 ns
    codel_count: torch.Tensor  # [H] i32
    codel_dropping: torch.Tensor  # [H] bool
    rx_backlog_bytes: torch.Tensor  # [H] i64
    codel_dropped: torch.Tensor  # [H] i64
    bytes_sent: torch.Tensor  # [H] i64
    bytes_recv: torch.Tensor  # [H] i64


def create(
    num_hosts: int, tx_bytes_per_interval=None, rx_bytes_per_interval=None, device="cpu"
) -> NetDevState:
    h = num_hosts
    i64 = torch.int64

    def _bw(v):
        if v is None:
            return torch.zeros((h,), dtype=i64, device=device)
        arr = torch.as_tensor(np.asarray(v, np.int64), device=device)
        if arr.ndim == 0:
            arr = torch.full((h,), int(arr), dtype=i64, device=device)
        return arr.clone()

    tx = _bw(tx_bytes_per_interval)
    rx = _bw(rx_bytes_per_interval)

    def z(dt=i64):
        return torch.zeros((h,), dtype=dt, device=device)

    return NetDevState(
        tx_refill=tx,
        tx_tokens=tx + MTU_BYTES,
        tx_last=z(),
        rx_refill=rx,
        rx_tokens=rx + MTU_BYTES,
        rx_last=z(),
        codel_first_above=torch.full((h,), -1, dtype=i64, device=device),
        codel_drop_next=z(),
        codel_count=z(torch.int32),
        codel_dropping=z(torch.bool),
        rx_backlog_bytes=z(),
        codel_dropped=z(),
        bytes_sent=z(),
        bytes_recv=z(),
    )


def bw_bits_per_sec_to_refill(bits_per_sec) -> np.ndarray:
    """Bandwidth in bits/s -> bucket refill bytes per interval (numpy i64).
    A configured-but-tiny bandwidth clamps to 1 byte (0 means unlimited)."""
    bps = np.asarray(bits_per_sec, np.int64)
    refill = (bps // 8) * REFILL_INTERVAL_NS // 1_000_000_000
    return np.where(bps > 0, np.maximum(refill, 1), 0).astype(np.int64)


def tb_depart(tokens, last, refill, now, size, charge):
    """Closed-form conforming-remove. Returns (depart_time, tokens',
    last'); where `charge` is False or refill == 0 the packet departs at
    `now` and the state is unchanged."""
    limited = charge & (refill > 0)
    safe_refill = torch.clamp(refill, min=1)
    cap = refill + MTU_BYTES
    intervals = torch.clamp(now - last, min=0) // REFILL_INTERVAL_NS
    cur = torch.minimum(cap, tokens + intervals * safe_refill)
    cur_last = last + intervals * REFILL_INTERVAL_NS
    deficit = torch.clamp(size - cur, min=0)
    k = (deficit + safe_refill - 1) // safe_refill
    wait_end = cur_last + k * REFILL_INTERVAL_NS
    depart = torch.where(deficit > 0, wait_end, now)
    tokens_out = cur + k * safe_refill - size
    last_out = torch.where(deficit > 0, wait_end, cur_last)
    depart = torch.where(limited, depart, now)
    tokens_out = torch.where(limited, tokens_out, tokens)
    last_out = torch.where(limited, last_out, last)
    return depart, tokens_out, last_out


def tb_depart_lanes(tokens, last, refill, now, sizes, charge):
    """Serve L packets at the same instant `now` in lane order; exactly L
    sequential tb_depart calls. sizes/charge are [H, L]; returns
    (departs [H, L], tokens', last')."""
    limited = charge & (refill > 0)[:, None]
    safe_refill = torch.clamp(refill, min=1)
    cap = refill + MTU_BYTES
    intervals = torch.clamp(now - last, min=0) // REFILL_INTERVAL_NS
    cur = torch.minimum(cap, tokens + intervals * safe_refill)
    cur_last = last + intervals * REFILL_INTERVAL_NS
    pref = torch.cumsum(torch.where(limited, sizes, 0), dim=1)
    deficit = torch.clamp(pref - cur[:, None], min=0)
    k = (deficit + (safe_refill - 1)[:, None]) // safe_refill[:, None]
    k_prev = torch.cat([torch.zeros_like(k[:, :1]), k[:, :-1]], dim=1)
    seq_deficit = pref - cur[:, None] - k_prev * safe_refill[:, None]
    now_b = now[:, None].expand_as(sizes) if now.ndim else now.expand_as(sizes)
    departs = torch.where(
        limited & (seq_deficit > 0), cur_last[:, None] + k * REFILL_INTERVAL_NS, now_b
    )
    any_charged = limited.any(dim=1)
    k_last = torch.where(limited, k, 0).amax(dim=1)
    p_last = torch.where(limited, pref, 0).amax(dim=1)
    tokens_out = torch.where(any_charged, cur + k_last * safe_refill - p_last, tokens)
    last_out = torch.where(
        any_charged,
        torch.where(k_last > 0, cur_last + k_last * REFILL_INTERVAL_NS, cur_last),
        last,
    )
    return departs, tokens_out, last_out


def codel_dequeue(net: NetDevState, now, sojourn, active, control_table=None):
    """One CoDel dequeue step per host. Returns (drop, net')."""
    below = (sojourn < CODEL_TARGET_NS) | (net.rx_backlog_bytes < MTU_BYTES)
    first_above = net.codel_first_above
    unset = first_above < 0
    new_first = torch.where(
        below,
        torch.full_like(first_above, -1),
        torch.where(unset, now + CODEL_INTERVAL_NS, first_above),
    )
    ok_to_drop = ~below & ~unset & (now >= first_above)

    dropping = net.codel_dropping
    count = net.codel_count
    drop_next = net.codel_drop_next

    leave = dropping & ~ok_to_drop
    drop_in_episode = dropping & ok_to_drop & (now >= drop_next)
    count_in = count + drop_in_episode.to(torch.int32)
    next_in = torch.where(
        drop_in_episode, drop_next + codel_control_law(count_in, control_table), drop_next
    )
    enter = ~dropping & ok_to_drop
    recent = (now - drop_next) < CODEL_INTERVAL_NS
    count_enter = torch.where(recent & (count > 2), count - 2, 1).to(torch.int32)
    next_enter = now + codel_control_law(count_enter, control_table)

    drop = active & (drop_in_episode | enter)
    new_dropping = torch.where(active, (dropping & ~leave) | enter, dropping)
    new_count = torch.where(
        active & enter, count_enter, torch.where(active, count_in, count)
    )
    new_next = torch.where(
        active & enter, next_enter, torch.where(active, next_in, drop_next)
    )
    new_first = torch.where(active, new_first, first_above)
    return drop, dataclasses.replace(
        net,
        codel_first_above=new_first,
        codel_dropping=new_dropping,
        codel_count=new_count,
        codel_drop_next=new_next,
    )
