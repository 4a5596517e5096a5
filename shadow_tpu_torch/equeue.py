"""Vectorized per-host event queues as fixed-slot tensors (port of
shadow_tpu/equeue.py).

H hosts x Q slots. A slot is free when its time is TIME_MAX (a
tombstone); "pop" is a masked argmin over the total-order key
(time, tie), and pushes fill free slots by rank over the free mask.
`head_time` caches each row's minimum time and is maintained exactly as
the reference maintains it (pushes: running min; pops: row rescan).
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.events import KIND_INVALID, tie_src_host
from shadow_tpu_torch.simtime import TIME_MAX

PAYLOAD_LANES = 8

I64_MAX = (1 << 63) - 1


@dataclasses.dataclass
class EventQueue:
    """H x Q event slots + per-host fill counts."""

    time: torch.Tensor  # [H, Q] i64 ns; TIME_MAX in empty slots
    tie: torch.Tensor  # [H, Q] i64; I64_MAX when empty
    kind: torch.Tensor  # [H, Q] i32; KIND_INVALID when empty
    data: torch.Tensor  # [H, Q, PAYLOAD_LANES] i32
    aux: torch.Tensor  # [H, Q] i32 (packet size | shaped flag)
    count: torch.Tensor  # [H] i32 number of valid slots
    overflow: torch.Tensor  # [H] i32 events dropped for lack of slots
    head_time: torch.Tensor  # [H] i64 cached row minimum of `time`

    @property
    def num_hosts(self) -> int:
        return self.time.shape[0]

    @property
    def capacity(self) -> int:
        return self.time.shape[1]


def create(num_hosts: int, capacity: int, device="cpu") -> EventQueue:
    h, q = num_hosts, capacity
    i64, i32 = torch.int64, torch.int32
    return EventQueue(
        time=torch.full((h, q), TIME_MAX, dtype=i64, device=device),
        tie=torch.full((h, q), I64_MAX, dtype=i64, device=device),
        kind=torch.full((h, q), KIND_INVALID, dtype=i32, device=device),
        data=torch.zeros((h, q, PAYLOAD_LANES), dtype=i32, device=device),
        aux=torch.zeros((h, q), dtype=i32, device=device),
        count=torch.zeros((h,), dtype=i32, device=device),
        overflow=torch.zeros((h,), dtype=i32, device=device),
        head_time=torch.full((h,), TIME_MAX, dtype=i64, device=device),
    )


def next_time(q: EventQueue) -> torch.Tensor:
    """[H] i64: each host's earliest pending event time (TIME_MAX if none)."""
    return q.head_time


@dataclasses.dataclass
class Popped:
    """One popped event per host (valid marks hosts that actually popped)."""

    valid: torch.Tensor  # [H] bool
    time: torch.Tensor  # [H] i64
    tie: torch.Tensor  # [H] i64
    kind: torch.Tensor  # [H] i32
    data: torch.Tensor  # [H, PAYLOAD_LANES] i32
    aux: torch.Tensor  # [H] i32

    @property
    def src_host(self) -> torch.Tensor:
        return tie_src_host(self.tie).to(torch.int32)


def peek_min(q: EventQueue, want: torch.Tensor) -> "tuple[Popped, torch.Tensor]":
    """Each host's minimum event by (time, tie), without removing it; the
    first slot wins a tie. Returns (event, slot)."""
    tmin = q.head_time
    at_min = q.time == tmin[:, None]
    tie_masked = torch.where(at_min, q.tie, I64_MAX)
    slot = torch.argmin(tie_masked, dim=1)
    valid = want & (q.count > 0)
    sl1 = slot[:, None]
    ev = Popped(
        valid=valid,
        time=tmin,
        tie=torch.gather(q.tie, 1, sl1)[:, 0],
        kind=torch.gather(q.kind, 1, sl1)[:, 0],
        data=torch.gather(q.data, 1, sl1[:, :, None].expand(-1, 1, q.data.shape[2]))[:, 0],
        aux=torch.gather(q.aux, 1, sl1)[:, 0],
    )
    return ev, slot


def clear_slot(q: EventQueue, slot: torch.Tensor, mask: torch.Tensor) -> EventQueue:
    """Tombstone q[h, slot[h]] where mask[h]; kind/data/aux keep their
    stale contents, as in the reference. Only those rows rescan their
    head time: another row's is its minimum already, except on a
    compacted sub-state's sentinel lane (engine/round.py::compact_step),
    whose head is held at TIME_MAX, as the kernel holds it."""
    slot_idx = torch.arange(q.capacity, device=slot.device)[None, :]
    clear = (slot_idx == slot[:, None]) & mask[:, None]
    new_time = torch.where(clear, TIME_MAX, q.time)
    return dataclasses.replace(
        q,
        time=new_time,
        tie=torch.where(clear, I64_MAX, q.tie),
        count=q.count - mask.to(torch.int32),
        head_time=torch.where(mask, torch.amin(new_time, dim=1), q.head_time),
    )


def pop_min(q: EventQueue, want: torch.Tensor) -> "tuple[Popped, EventQueue]":
    ev, slot = peek_min(q, want)
    return ev, clear_slot(q, slot, ev.valid)


def _free_columns(q: EventQueue) -> "tuple[torch.Tensor, torch.Tensor]":
    """(free [H, Q] bool, col_of [H, Q] i64): col_of[h, r] is the column
    of row h's r-th free slot (entries past the free count are junk)."""
    free = q.time == TIME_MAX
    fr = torch.cumsum(free.to(torch.int64), dim=1) - 1
    h, cap = free.shape
    col_of = torch.zeros((h, cap), dtype=torch.int64, device=free.device)
    rows = torch.arange(h, device=free.device)[:, None].expand(h, cap)
    cols = torch.arange(cap, device=free.device)[None, :].expand(h, cap)
    col_of[rows[free], fr[free]] = cols[free]
    return free, col_of


def push_self(q, valid, time, tie, kind, data, aux=None) -> EventQueue:
    """Each host pushes at most one event into its own first free slot."""
    if aux is None:
        aux = torch.zeros_like(kind)
    return push_self_lanes(
        q, valid[:, None], time[:, None], tie[:, None], kind[:, None],
        data[:, None, :], aux[:, None],
    )


def push_self_lanes(q, valid, time, tie, kind, data, aux=None) -> EventQueue:
    """Each host pushes up to L events into its own queue, in lane order:
    lane l (l-th valid lane) lands in the row's l-th free slot. A push at
    TIME_MAX (the free-slot marker) is rejected and counted in overflow.
    Same slot assignment as the reference's fused where-chain, done with
    one scatter per array."""
    if valid.shape[1] == 0:
        return q
    if aux is None:
        aux = torch.zeros_like(kind)
    sentinel = valid & (time >= TIME_MAX)
    valid = valid & ~sentinel
    vi = valid.to(torch.int64)
    ranks = torch.cumsum(vi, dim=1) - vi
    room = (q.capacity - q.count).to(torch.int64)
    write = valid & (ranks < room[:, None])
    _, col_of = _free_columns(q)
    h, lanes = valid.shape
    rows = torch.arange(h, device=valid.device)[:, None].expand(h, lanes)
    cols = torch.gather(col_of, 1, ranks.clamp(max=q.capacity - 1))
    r, c = rows[write], cols[write]
    new_time = q.time.clone()
    new_tie = q.tie.clone()
    new_kind = q.kind.clone()
    new_data = q.data.clone()
    new_aux = q.aux.clone()
    new_time[r, c] = time[write]
    new_tie[r, c] = tie[write]
    new_kind[r, c] = kind[write]
    new_data[r, c] = data[write]
    new_aux[r, c] = aux[write]
    head_new = torch.amin(torch.where(write, time, TIME_MAX), dim=1)
    return dataclasses.replace(
        q,
        time=new_time,
        tie=new_tie,
        kind=new_kind,
        data=new_data,
        aux=new_aux,
        count=q.count + write.sum(dim=1).to(torch.int32),
        overflow=q.overflow + ((valid & ~write) | sentinel).sum(dim=1).to(torch.int32),
        head_time=torch.minimum(q.head_time, head_new),
    )


def push_many(q, dst, valid, time, tie, kind, data, aux=None) -> EventQueue:
    """Batched push of M events to arbitrary destination hosts, with a
    full-capacity delivery grid (exact, never grid-bounded)."""
    return push_many_sorted(
        q, dst, valid, time, tie, kind, data, aux, deliver_lanes=q.capacity
    )


def push_many_sorted(
    q, dst, valid, time, tie, kind, data, aux=None, deliver_lanes: int = 48,
    rows_per_world: int = 0,
) -> EventQueue:
    """The dense round-boundary landing. Entries are grouped by
    destination with a stable sort (arrival order kept within a
    destination); the r-th arrival at destination d fills lane r of d's
    row in a [H, D] delivery grid (D = min(deliver_lanes, M)), and the
    grid lands with push_self_lanes. Arrivals beyond D are counted in
    overflow on row 0 — on an ensemble's rows (`rows_per_world` rows per
    replica), on the first row of the replica they were sent in. This is
    the grid the reference builds from three multi-operand sorts,
    computed with one stable sort and a scatter."""
    if aux is None:
        aux = torch.zeros_like(kind)
    m = dst.shape[0]
    h = q.num_hosts
    d = min(deliver_lanes, m)
    dev = dst.device
    key1 = torch.where(valid, dst.to(torch.int64), h)
    key1_s, order = torch.sort(key1, stable=True)
    pos = torch.arange(m, device=dev)
    seg_start = torch.ones(m, dtype=torch.bool, device=dev)
    seg_start[1:] = key1_s[1:] != key1_s[:-1]
    start_pos = torch.cummax(torch.where(seg_start, pos, -1), dim=0).values
    rank = pos - start_pos
    real = key1_s < h
    fits = real & (rank < d)
    idx = order[fits]
    gr, gl = key1_s[fits], rank[fits]

    g_valid = torch.zeros((h, d), dtype=torch.bool, device=dev)
    g_time = torch.full((h, d), TIME_MAX, dtype=torch.int64, device=dev)
    g_tie = torch.zeros((h, d), dtype=torch.int64, device=dev)
    g_kind = torch.zeros((h, d), dtype=torch.int32, device=dev)
    g_aux = torch.zeros((h, d), dtype=torch.int32, device=dev)
    g_data = torch.zeros((h, d, data.shape[1]), dtype=torch.int32, device=dev)
    g_valid[gr, gl] = True
    g_time[gr, gl] = time[idx]
    g_tie[gr, gl] = tie[idx]
    g_kind[gr, gl] = kind[idx]
    g_aux[gr, gl] = aux[idx]
    g_data[gr, gl] = data[idx]

    q2 = push_self_lanes(q, g_valid, g_time, g_tie, g_kind, g_data, g_aux)
    ov = _add_on_first_rows(q2.overflow, key1_s, real & ~fits, rows_per_world)
    return dataclasses.replace(q2, overflow=ov)


def _add_on_first_rows(overflow, rows, counted, rows_per_world: int):
    """overflow plus the `counted` entries, each on row 0 of the world
    (`rows_per_world` rows each) whose row it names; one world: row 0."""
    h = overflow.shape[0]
    ov = overflow.clone()
    if 0 < rows_per_world < h:
        world = torch.clamp(rows, 0, h - 1) // rows_per_world
        ov.reshape(-1, rows_per_world)[:, 0].index_add_(0, world, counted.to(torch.int32))
    else:
        ov[0] += counted.sum().to(torch.int32)
    return ov


def push_many_segment(q, dst, valid, time, tie, kind, data, aux=None,
                      rows_per_world: int = 0) -> EventQueue:
    """The segment landing (event-exchange v2): one stable destination
    sort, each entry's rank within its destination's segment from a
    cummax, and the r-th arrival at row d landing in d's r-th free column
    (one M-sized scatter per queue array) where r < the row's free-slot
    count. Capacity is checked once per row: a row's arrivals past its
    room count into that row's overflow. A push at TIME_MAX (the
    free-slot marker) is rejected and counted on row 0 (on an ensemble's
    rows, `rows_per_world` rows per replica, on the first row of its
    replica). The slot layout is the reference's: arrivals keep their
    order in `dst`'s stable sort."""
    if aux is None:
        aux = torch.zeros_like(kind)
    m = dst.shape[0]
    h, cap = q.num_hosts, q.capacity
    dev = dst.device
    sentinel = valid & (time >= TIME_MAX)
    valid = valid & ~sentinel
    key1 = torch.where(valid, dst.to(torch.int64), h)
    key1_s, order = torch.sort(key1, stable=True)
    pos = torch.arange(m, device=dev)
    seg_start = torch.ones(m, dtype=torch.bool, device=dev)
    seg_start[1:] = key1_s[1:] != key1_s[:-1]
    rank = pos - torch.cummax(torch.where(seg_start, pos, -1), dim=0).values
    real = key1_s < h
    cnt = torch.bincount(key1_s[real], minlength=h).to(torch.int32)  # arrivals per row
    room = (cap - q.count).to(torch.int32)  # == the row's free slots
    fits = real & (rank < room[torch.clamp(key1_s, max=h - 1)])
    _, col_of = _free_columns(q)
    r, src = key1_s[fits], order[fits]
    c = col_of[r, rank[fits]]

    def land(arr, vals):
        out = arr.clone()
        out[r, c] = vals[src]
        return out

    head_new = torch.full((h,), TIME_MAX, dtype=torch.int64, device=dev).scatter_reduce(
        0, r, time[src], "amin")
    landed = torch.minimum(cnt, room)
    ov = _add_on_first_rows(q.overflow + (cnt - landed), dst.to(torch.int64), sentinel,
                            rows_per_world)
    return dataclasses.replace(
        q,
        time=land(q.time, time),
        tie=land(q.tie, tie),
        kind=land(q.kind, kind),
        data=land(q.data, data),
        aux=land(q.aux, aux),
        count=q.count + landed,
        overflow=ov,
        head_time=torch.minimum(q.head_time, head_new),
    )
