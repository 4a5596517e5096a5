"""The conservative-PDES round engine (port of shadow_tpu/engine/round.py:
the dense and segment exchanges, on one device or between host shards,
active-set compaction, fixed, adaptive and dynamic runahead windows).

Each round is a window [start, window_end) in which every host drains
its own event queue; cross-host packets stage into per-host outboxes
with delivery clamped to >= window end, and one batched exchange at the
round boundary lands them. Inside a round every host with an eligible
event pops its minimum-key event at once; the iteration count is the
largest number of events any host handles in the window.

The reference's jitted while_loop and scan become Python loops whose
conditions are read from the device once per iteration (drain loop) or
once per round (window choice); `iters_done` and `lanes_live` count
exactly as the reference counts them.

Every function here also takes an ensemble's rows view
(engine/state.py::rows_view): R worlds as R * H host rows, with window
ends, rejected flags and the other per-world values as [R] tensors. Each
replica's rows see only their own replica's values, as the reference's
vmap over the replica axis gives them (engine/ensemble.py).

Where the reference takes an `axis_name` (its engine under shard_map),
run_round, _next_window_end, flush_outbox and state_probe take a
ShardContext and the list of a world's shard states: the window's pmins
and the traffic psum become reductions over the shards, the exchange's
collectives (all_to_all buckets, all_gather, the segment ring) explicit
moves between them (engine/sharded.py drives the rounds).
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import threading
import time

import numpy as np
import torch

from shadow_tpu_torch import equeue, netstack, rng
from shadow_tpu_torch.engine.state import (
    EngineConfig,
    SimState,
    map_host_leaves,
    per_replica,
    per_row,
    replicas_of,
)
from shadow_tpu_torch.events import KIND_PACKET, pack_tie
from shadow_tpu_torch.graph.routing import RoutingTables
from shadow_tpu_torch.netstack import AUX_SHAPED_BIT, AUX_SIZE_MASK
from shadow_tpu_torch.runtime import chaos, flightrec
from shadow_tpu_torch.simtime import TIME_MAX

_W = torch.where


@dataclasses.dataclass(frozen=True)
class Draw:
    """Per-host counter-based draw access for one handler invocation:
    logical draw i of this event = threefry(host_key, counter + i). The
    engine advances counters by the fixed per-event stride afterwards, so
    draws are in event-execution order per host."""

    key: torch.Tensor  # [H, 2]
    counter: torch.Tensor  # [H] u32 in i64

    def uniform(self, i: int) -> torch.Tensor:
        return rng.uniform_f32(self.key, (self.counter + i) & rng.MASK32)

    def uniform_int(self, i: int, lo, hi) -> torch.Tensor:
        return rng.uniform_int(self.key, (self.counter + i) & rng.MASK32, lo, hi)

    def exponential_ns(self, i: int, mean_ns) -> torch.Tensor:
        return rng.exponential_ns(self.key, (self.counter + i) & rng.MASK32, mean_ns)


def _lane_seqs(valid: torch.Tensor, base: torch.Tensor):
    """Per-lane sequence numbers: base + (# valid lanes before this one),
    wrapping at 2**32."""
    vi = valid.to(torch.int64)
    ranks = torch.cumsum(vi, dim=1) - vi
    lane = (base[:, None] + ranks) & rng.MASK32
    nxt = (base + vi.sum(dim=1)) & rng.MASK32
    return lane, nxt


def _replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass(frozen=True)
class ShardContext:
    """The port's counterpart of the reference's mesh axis (`axis_name`):
    the S host shards of one world, or of one row of a mesh's replicas,
    shard j holding hosts j * hosts_per_shard .. (j + 1) * hosts_per_shard
    - 1 on devices[j]. One controller drives every shard (the
    reference's shard_map has one too); the cross-shard steps of a round
    are explicit steps between the shards' phases: the window's pmins and
    the traffic psum are reductions over the shards' values on
    devices[0] (pmin, pany), the exchange moves buckets with
    `.to(device)` (_flush_shards_dense, _ring_exchange)."""

    devices: tuple
    hosts_per_shard: int

    @property
    def size(self) -> int:
        return len(self.devices)

    def gather(self, xs) -> torch.Tensor:
        """The shards' values stacked on devices[0]."""
        return torch.stack([x.to(self.devices[0]) for x in xs])

    def pmin(self, xs) -> torch.Tensor:
        return self.gather(xs).amin(dim=0)

    def pany(self, xs) -> torch.Tensor:
        return self.gather(xs).any(dim=0)

    def scatter(self, x) -> list:
        """A value on devices[0] as each shard sees it, on its device."""
        return [None if x is None else x.to(d) for d in self.devices]


def bootstrap(st: SimState, model, cfg: EngineConfig) -> SimState:
    """Push the model's initial events."""
    host_ids = st.host_id
    draw = Draw(st.rng_key, st.rng_counter)
    lemits = model.bootstrap(draw, host_ids)
    lseq, seq_final = _lane_seqs(lemits.valid, st.seq)
    queue = equeue.push_self_lanes(
        st.queue,
        valid=lemits.valid,
        time=lemits.time,
        tie=pack_tie(lemits.kind, host_ids[:, None].expand_as(lemits.valid), lseq),
        kind=lemits.kind,
        data=lemits.data,
    )
    return _replace(
        st,
        queue=queue,
        seq=seq_final,
        rng_counter=(st.rng_counter + model.BOOTSTRAP_DRAWS) & rng.MASK32,
    )


def handle_one_iteration(
    st: SimState, window_end, model, tables: RoutingTables, cfg: EngineConfig,
    rows: "torch.Tensor | None" = None,
) -> SimState:
    """Pop + handle one event per eligible host; stage emissions. `rows`
    (bool per row), when given, limits the pass to those rows: any other
    row pops nothing and is left as it was."""
    host_ids = st.host_id
    h = host_ids.shape[0]
    dev = host_ids.device
    i64, i32 = torch.int64, torch.int32
    replicas = replicas_of(st)
    window_end = per_row(st, window_end)
    we_col = window_end if replicas is None else window_end[:, None]

    want = equeue.next_time(st.queue) < window_end
    if rows is not None:
        want = want & rows
    ev, q = equeue.pop_min(st.queue, want)
    st = _replace(st, queue=q)

    net = st.net
    defer = torch.zeros_like(ev.valid)
    ready = ev.time
    size_in = torch.zeros_like(ev.time)
    if cfg.use_netstack:
        # ingress: down-bw relay + CoDel at the upstream router
        is_pkt = ev.valid & (ev.kind == KIND_PACKET)
        size_in = (ev.aux & AUX_SIZE_MASK).to(i64)
        shaped = (ev.aux & AUX_SHAPED_BIT) != 0
        loopback = ev.src_host == host_ids
        in_bootstrap = ev.time < cfg.bootstrap_end_ns
        finish = is_pkt & shaped
        net = _replace(net, rx_backlog_bytes=net.rx_backlog_bytes - _W(finish, size_in, 0))
        need = is_pkt & ~shaped & ~loopback & ~in_bootstrap & (net.rx_refill > 0)
        ready, rx_tok, rx_last = netstack.tb_depart(
            net.rx_tokens, net.rx_last, net.rx_refill, ev.time, size_in, need
        )
        codel_drop, net = netstack.codel_dequeue(net, ready, ready - ev.time, need)
        keep_in = need & ~codel_drop
        net = _replace(
            net,
            rx_tokens=_W(keep_in, rx_tok, net.rx_tokens),
            rx_last=_W(keep_in, rx_last, net.rx_last),
            codel_dropped=net.codel_dropped + codel_drop.to(i64),
        )
        defer = keep_in & (ready > ev.time)
        net = _replace(net, rx_backlog_bytes=net.rx_backlog_bytes + _W(defer, size_in, 0))
        if hasattr(model, "on_codel_drop"):
            st = _replace(st, model=model.on_codel_drop(st.model, ev, codel_drop))
        ev = _replace(ev, valid=ev.valid & ~(defer | codel_drop))
        net = _replace(net, bytes_recv=net.bytes_recv + _W(ev.valid & is_pkt, size_in, 0))

    draw = Draw(st.rng_key, st.rng_counter)
    model_before = st.model
    mstate, lemits, pemits = model.handle(st.model, ev, draw, cfg, host_ids)

    lvalid = lemits.valid & ev.valid[:, None]
    pvalid = pemits.valid & ev.valid[:, None]
    ep = pvalid.shape[1]

    # --- packet path: routing lookup, loss draw, delivery clamp ---
    src_node = tables.host_node[host_ids.to(i64)].to(i64)
    dst_clamped = torch.clamp(pemits.dst, 0, tables.num_global_hosts - 1)
    dst_node = tables.host_node[dst_clamped.to(i64)].to(i64)
    lat = tables.lat_ns[src_node[:, None], dst_node]
    rel = tables.rel[src_node[:, None], dst_node]

    unroutable = pvalid & (lat >= TIME_MAX)
    loss_lane = getattr(model, "LOSS_COUNTER_LANE", None)
    if loss_lane is None:
        # one loss draw per packet lane, drawn in lane order
        ctrs = (
            draw.counter[:, None]
            + model.DRAWS_PER_EVENT
            + torch.arange(ep, dtype=i64, device=dev)[None, :]
        ) & rng.MASK32
    else:
        # hybrid managed traffic: the counter was allocated from the
        # host's stream at send time on the CPU and rides the payload (as
        # i32 bits of a u32), so the uniform equals the serial kernel's
        ctrs = pemits.data[:, :, loss_lane].to(i64) & rng.MASK32
    loss_u = rng.uniform_f32_grid(draw.key, ctrs)
    passed = loss_u < rel
    kept = pvalid & ~unroutable & passed
    dropped = pvalid & ~unroutable & ~passed

    if cfg.use_netstack:
        # egress: up-bw relay charged in lane order at emit time
        sizes = pemits.size.to(i64)
        in_bootstrap_tx = ev.time < cfg.bootstrap_end_ns
        tx_tok, tx_last = net.tx_tokens, net.tx_last
        deps = []
        for lane in range(ep):
            loopb = dst_clamped[:, lane] == host_ids
            charge = (pvalid[:, lane] & ~unroutable[:, lane]) & ~loopb & ~in_bootstrap_tx
            dep_p, tx_tok, tx_last = netstack.tb_depart(
                tx_tok, tx_last, net.tx_refill, ev.time, sizes[:, lane], charge
            )
            deps.append(dep_p)
        dep = torch.stack(deps, dim=1)
        net = _replace(
            net,
            tx_tokens=tx_tok,
            tx_last=tx_last,
            bytes_sent=net.bytes_sent + _W(kept, sizes, 0).sum(dim=1),
        )
        deliver = torch.maximum(dep + lat, we_col)
    else:
        deliver = torch.maximum(ev.time[:, None] + lat, we_col)

    if hasattr(model, "on_packet_outcomes"):
        mstate = model.on_packet_outcomes(
            mstate, ev, pemits, kept, dropped, unroutable, deliver, dst_clamped
        )

    # --- sequence numbers: local lanes first, then surviving packets ---
    lseq, seq_after_locals = _lane_seqs(lvalid, st.seq)
    pseq, seq_final = _lane_seqs(kept, seq_after_locals)

    # --- push local events (the relay defer rides as lane 0) ---
    el = lvalid.shape[1]
    lane_tie = pack_tie(lemits.kind, host_ids[:, None].expand_as(lvalid), lseq)
    if cfg.use_netstack:
        p_valid = torch.cat([defer[:, None], lvalid], dim=1)
        p_time = torch.cat([ready[:, None], lemits.time], dim=1)
        p_tie = torch.cat([ev.tie[:, None], lane_tie], dim=1)
        p_kind = torch.cat([ev.kind[:, None], lemits.kind], dim=1)
        p_data = torch.cat([ev.data[:, None, :], lemits.data], dim=1)
        p_aux = torch.cat(
            [
                (size_in.to(i32) | AUX_SHAPED_BIT)[:, None],
                torch.zeros((h, el), dtype=i32, device=dev),
            ],
            dim=1,
        )
    else:
        p_valid, p_time, p_tie = lvalid, lemits.time, lane_tie
        p_kind, p_data = lemits.kind, lemits.data
        p_aux = torch.zeros((h, el), dtype=i32, device=dev)
    queue = equeue.push_self_lanes(
        st.queue, valid=p_valid, time=p_time, tie=p_tie, kind=p_kind,
        data=p_data, aux=p_aux,
    )

    # --- stage surviving packets into own outbox rows ---
    ob = st.outbox
    o_cap = ob.valid.shape[1]
    lane_idx = torch.arange(o_cap, device=dev)[None, :]
    fill, overflow = ob.fill, ob.overflow
    obv, obd, obt, obtie, obdata, obaux = ob.valid, ob.dst, ob.time, ob.tie, ob.data, ob.aux
    pkt_kind = torch.full((h,), KIND_PACKET, dtype=i32, device=dev)
    for lane in range(ep):
        has_room = fill < o_cap
        write = kept[:, lane] & has_room
        at = (lane_idx == fill[:, None]) & write[:, None]
        tie = pack_tie(pkt_kind, host_ids, pseq[:, lane])
        obv = obv | at
        obd = _W(at, dst_clamped[:, lane][:, None], obd)
        obt = _W(at, deliver[:, lane][:, None], obt)
        obtie = _W(at, tie[:, None], obtie)
        obdata = _W(at[:, :, None], pemits.data[:, lane, None, :], obdata)
        obaux = _W(at, (pemits.size[:, lane] & AUX_SIZE_MASK)[:, None], obaux)
        fill = fill + write.to(i32)
        overflow = overflow + (kept[:, lane] & ~has_room).to(i32)
    ob = _replace(
        ob, valid=obv, dst=obd, time=obt, tie=obtie, data=obdata, aux=obaux,
        fill=fill, overflow=overflow,
    )

    min_used = st.min_used_lat
    if cfg.use_dynamic_runahead:
        cross = dst_clamped != host_ids[:, None]
        used = _W(kept & cross & (lat < TIME_MAX), lat, TIME_MAX)
        used = used.amin() if replicas is None else per_replica(st, used).amin(dim=1)
        min_used = torch.minimum(min_used, used)

    # --- tracker plane ---
    tracker = st.tracker
    if cfg.tracker:
        tcp_range = getattr(model, "TCP_KIND_RANGE", None)
        if tcp_range is not None:
            lo, hi = (int(x) for x in tcp_range)
            is_tcp_ev = ev.valid & (ev.kind >= lo) & (ev.kind < hi)
        else:
            is_tcp_ev = torch.zeros_like(ev.valid)
        is_local_ev = ev.valid & (ev.kind != KIND_PACKET) & ~is_tcp_ev
        hdr = int(getattr(model, "WIRE_HEADER_BYTES", 0))
        sizes64 = pemits.size.to(i64)
        is_ctrl = kept & (pemits.size <= hdr)
        spec = getattr(model, "pump_spec", None)
        if spec is not None:
            rtx_delta = (
                spec.get_tcp(mstate).retransmits - spec.get_tcp(model_before).retransmits
            ).sum(dim=1)
        else:
            rtx_delta = torch.zeros_like(tracker.retrans_segs)
        tracker = _replace(
            tracker,
            ev_local=tracker.ev_local + is_local_ev.to(i64),
            ev_tcp=tracker.ev_tcp + is_tcp_ev.to(i64),
            bytes_ctrl=tracker.bytes_ctrl + _W(is_ctrl, sizes64, 0).sum(dim=1),
            bytes_data=tracker.bytes_data + _W(kept & ~is_ctrl, sizes64, 0).sum(dim=1),
            retrans_segs=tracker.retrans_segs + rtx_delta,
        )

    # carried-counter models consume no live draws for packet loss
    stride = model.DRAWS_PER_EVENT + (0 if loss_lane is not None else ep)
    return _replace(
        st,
        queue=queue,
        min_used_lat=min_used,
        outbox=ob,
        net=net,
        model=mstate,
        seq=seq_final,
        rng_counter=(st.rng_counter + stride * ev.valid.to(i64)) & rng.MASK32,
        events_handled=st.events_handled + ev.valid.to(i64),
        packets_sent=st.packets_sent + kept.sum(dim=1),
        packets_dropped=st.packets_dropped + dropped.sum(dim=1),
        packets_unroutable=st.packets_unroutable + unroutable.sum(dim=1),
        tracker=tracker,
    )


def model_pump_capable(model) -> bool:
    """Whether the pump/megakernel fast paths can honor this model."""
    return (
        getattr(model, "pump_spec", None) is not None
        and getattr(model, "LOSS_COUNTER_LANE", None) is None
        and not hasattr(model, "on_packet_outcomes")
        and not hasattr(model, "on_codel_drop")
    )


def flush_outbox(st, cfg: "EngineConfig | None" = None, shards=None):
    """Round-boundary exchange: deliver staged packets into destination
    queues (empty rounds skip the exchange entirely). With `shards`, `st`
    is the list of a world's shard states, and the exchange runs when any
    shard has a packet staged (the reference's psum of the predicate):
    every shard then takes part, as every device enters the collective."""
    if shards is None:
        if not bool(st.outbox.valid.any()):
            return st
    elif not bool(shards.pany([c.outbox.valid.any() for c in st])):
        return st
    return _flush_outbox_traffic(st, cfg, shards)


def _fresh_outbox(ob, pool_drop=None):
    """The outbox after a flush: no entry staged; `pool_drop` ([R], or one
    value) counts into the overflow of each world's first row."""
    overflow = ob.overflow
    if pool_drop is not None:
        overflow = overflow.clone()
        overflow.reshape(pool_drop.numel(), -1)[:, 0] += pool_drop.reshape(-1)
    return _replace(
        ob,
        valid=torch.zeros_like(ob.valid),
        time=torch.full_like(ob.time, TIME_MAX),
        fill=torch.zeros_like(ob.fill),
        overflow=overflow,
    )


def _flush_outbox_traffic(st, cfg: "EngineConfig | None" = None, shards=None):
    if cfg is not None and cfg.exchange == "segment":
        return _flush_segment(st, cfg, shards)
    if shards is not None:
        return _flush_shards_dense(st, cfg, shards)
    ob = st.outbox
    h, o_cap = ob.valid.shape
    m = h * o_cap
    replicas = replicas_of(st)
    # a packet's dst is a host id within its sender's world; an
    # ensemble's replica r lands it in row r * H + dst, and a dst out of
    # that world's range is dropped as it is in a single run
    h_world = h if replicas is None else h // replicas

    def flat(x):
        return x.reshape((m,) + tuple(x.shape[2:]))

    valid, dst = flat(ob.valid), flat(ob.dst)
    mine = valid & (dst >= 0) & (dst < h_world)
    if replicas is not None:
        first_row = torch.arange(m, device=dst.device) // (h_world * o_cap) * h_world
        dst = dst.to(torch.int64) + first_row
    lanes = cfg.deliver_lanes if cfg is not None else 0
    queue = equeue.push_many_sorted(
        st.queue,
        dst=dst,
        valid=mine,
        time=flat(ob.time),
        tie=flat(ob.tie),
        kind=torch.full((m,), KIND_PACKET, dtype=torch.int32, device=dst.device),
        data=flat(ob.data),
        aux=flat(ob.aux),
        deliver_lanes=lanes if lanes > 0 else st.queue.capacity,
        rows_per_world=h_world,
    )
    return _replace(st, queue=queue, outbox=_fresh_outbox(ob))


def _pool_order(key, time, tie):
    """[W, M] permutation: each line's entries in the stable order of the
    key triple (key, time, tie), as one stable multi-key sort orders them:
    stable single-key sorts, least significant key first."""
    perm = torch.arange(key.shape[1], device=key.device).expand_as(key)
    for k in (tie, time, key):
        _, idx = torch.sort(torch.gather(k, 1, perm), dim=1, stable=True)
        perm = torch.gather(perm, 1, idx)
    return perm


def _flush_segment(st, cfg: EngineConfig, shards=None):
    """The segment exchange (exchange="segment"): each world's staged
    entries sorted stably by (destination, time, tie), valid ones first,
    into a pool; the pool's first pool_capacity entries (0: the whole
    outbox, never truncating) land through equeue.push_many_segment, and
    the valid entries cut off count into the outbox overflow of the
    world's first row. On an ensemble's rows each replica has a pool of
    its own, as under the reference's vmap. Pop order equals the dense
    exchange's; slot placement differs. With `shards`, each shard pools
    its own outbox and the pools move between shards over the ring
    (_ring_exchange)."""
    if shards is not None:
        return _flush_shards_segment(st, cfg, shards)
    ob = st.outbox
    h, o_cap = ob.valid.shape
    worlds = replicas_of(st) or 1
    h_world = h // worlds
    pool, e_max, pool_drop = _segment_pool(st, cfg)
    valid_p, dst_p = pool["valid"].reshape(-1), pool["dst"].reshape(-1).to(torch.int64)
    mine = valid_p & (dst_p >= 0) & (dst_p < h_world)
    first_row = torch.arange(worlds * e_max, device=dst_p.device) // e_max * h_world
    queue = equeue.push_many_segment(
        st.queue,
        dst=dst_p + first_row,
        valid=mine,
        time=pool["time"].reshape(-1),
        tie=pool["tie"].reshape(-1),
        kind=torch.full((worlds * e_max,), KIND_PACKET, dtype=torch.int32, device=dst_p.device),
        data=pool["data"].reshape((-1,) + tuple(pool["data"].shape[2:])),
        aux=pool["aux"].reshape(-1),
        rows_per_world=h_world,
    )
    return _replace(st, queue=queue, outbox=_fresh_outbox(ob, pool_drop))


_OUTBOX_FIELDS = ("valid", "dst", "time", "tie", "data", "aux")
# the fill of an exchange bucket's empty slot, per outbox field
_BUCKET_FILL = {"valid": False, "dst": 0, "time": TIME_MAX, "tie": 0, "data": 0, "aux": 0}


def _outbox_lines(st: SimState) -> dict:
    """Each world's staged entries of one state, outbox field by field, as
    [W, M, ...] lines (M = the world's rows x outbox lanes, in row-major
    order; W = 1 for a single world)."""
    ob = st.outbox
    worlds = replicas_of(st) or 1
    return {k: getattr(ob, k).reshape((worlds, -1) + tuple(getattr(ob, k).shape[2:]))
            for k in _OUTBOX_FIELDS}


def _take(x, order):
    """x ([W, M, ...]) with each line's entries in `order` ([W, M'])."""
    idx = order.reshape(order.shape + (1,) * (x.dim() - 2)).expand(
        tuple(order.shape) + tuple(x.shape[2:]))
    return torch.gather(x, 1, idx)


def _segment_pool(st: SimState, cfg: EngineConfig):
    """One state's segment pools: (pool, e_max, pool_drop). `pool` holds
    each world's first e_max staged entries in (destination, time, tie)
    order, valid ones first, field by field as [W, e_max, ...];
    pool_drop ([W] i32, or None when the pool holds the whole outbox)
    counts the valid entries cut off."""
    lines = _outbox_lines(st)
    m = lines["valid"].shape[1]
    key = torch.where(lines["valid"], lines["dst"].to(torch.int64), 1 << 30)
    e_max = min(cfg.pool_capacity or m, m)
    perm = _pool_order(key, lines["time"], lines["tie"])[:, :e_max]
    pool_drop = None
    if e_max < m:
        pool_drop = torch.clamp(lines["valid"].sum(dim=1) - e_max, min=0).to(torch.int32)
    return {k: _take(v, perm) for k, v in lines.items()}, e_max, pool_drop


def _segment_rank(keys):
    """Each entry's rank within its run of equal keys ([W, N] lines whose
    equal keys are adjacent)."""
    n = keys.shape[1]
    pos = torch.arange(n, device=keys.device).expand_as(keys)
    seg_start = torch.ones_like(keys, dtype=torch.bool)
    seg_start[:, 1:] = keys[:, 1:] != keys[:, :-1]
    return pos - torch.cummax(torch.where(seg_start, pos, -1), dim=1).values


def _bucketize(x, sdst, sslot, d: int, cap: int, fill):
    """x's entries ([W, N, ...]) placed at (sdst, sslot) of a [W, d, cap,
    ...] bucket stack; an entry at (d, cap) is dropped."""
    w, n = sdst.shape
    buf = torch.full((w, d + 1, cap + 1) + tuple(x.shape[2:]), fill, dtype=x.dtype,
                     device=x.device)
    wi = torch.arange(w, device=x.device)[:, None].expand(w, n)
    buf[wi, sdst, sslot] = x
    return buf[:, :d, :cap]


def _shard_buckets(lines: dict, shard_of, d: int, cap: int):
    """A shard's per-peer buckets: entries grouped by destination shard
    (`lines` already in that grouping, `shard_of` d for an invalid
    entry), the r-th entry for peer p in slot r of p's bucket while r <
    cap. Returns ({field: [W, d, cap, ...]}, [W] i32 count of the valid
    entries that did not fit)."""
    rank = _segment_rank(shard_of)
    fits = lines["valid"] & (rank < cap)
    sdst = torch.where(fits, shard_of, d)
    sslot = torch.where(fits, rank, cap)
    over = (lines["valid"] & ~fits).sum(dim=1).to(torch.int32)
    return {k: _bucketize(v, sdst, sslot, d, cap, _BUCKET_FILL[k]) for k, v in lines.items()}, over


def _ring_exchange(buckets: list, shards) -> list:
    """The ring collective of the segment exchange: `buckets[i]` is shard
    i's {field: [W, d, cap, ...]} per-peer stack. Shard i's bucket for
    peer p moves to p at ring step (p - i) mod d, as the reference's
    ppermute ring moves it; shard j receives its own bucket first, then
    shard j - 1's, j - 2's, ... Returns each shard's received
    {field: [W, d * cap, ...]}, on its device."""
    d = shards.size
    return [
        {k: torch.cat([buckets[(j - s) % d][k][:, j].to(dev) for s in range(d)], dim=1)
         for k in _OUTBOX_FIELDS}
        for j, dev in enumerate(shards.devices)
    ]


def _land(st: SimState, recv: dict, shard: int, hosts_per_shard: int, push, **kw):
    """Land a shard's received entries ({field: [W, N, ...]}, dst a host
    id of the world) on its rows through `push` (push_many_sorted or
    push_many_segment); entries for other shards' hosts are dropped."""
    local = recv["dst"].to(torch.int64) - shard * hosts_per_shard
    mine = recv["valid"] & (local >= 0) & (local < hosts_per_shard)
    w, n = mine.shape
    rows = local + torch.arange(w, device=local.device)[:, None] * hosts_per_shard
    data = recv["data"]
    return push(
        st.queue,
        dst=rows.reshape(-1),
        valid=mine.reshape(-1),
        time=recv["time"].reshape(-1),
        tie=recv["tie"].reshape(-1),
        kind=torch.full((w * n,), KIND_PACKET, dtype=torch.int32, device=local.device),
        data=data.reshape((w * n,) + tuple(data.shape[2:])),
        aux=recv["aux"].reshape(-1),
        rows_per_world=hosts_per_shard,
        **kw,
    )


def _flush_shards_dense(cells: list, cfg: "EngineConfig | None", shards) -> list:
    """The dense exchange over a world's shards. all_to_all ("dense" is
    its alias): each shard buckets its flattened outbox by destination
    shard (a stable sort keeps emission order in a bucket) into
    a2a_capacity slots per peer (<= 0: the whole outbox, never
    overflowing), counting the valid entries past a full bucket into the
    outbox overflow of its first row; shard j then lands the buckets the
    shards addressed to it, in shard order. all_gather: every shard
    lands every shard's whole outbox, in shard order, keeping its own
    hosts' entries."""
    mode = cfg.exchange if cfg is not None else "all_gather"
    d, hl = shards.size, shards.hosts_per_shard
    lines = [_outbox_lines(c) for c in cells]
    over = [None] * d
    if mode in ("all_to_all", "dense"):
        m = lines[0]["valid"].shape[1]
        cap = cfg.a2a_capacity if cfg.a2a_capacity > 0 else m
        sent = []
        for i, lin in enumerate(lines):
            shard_of = torch.where(lin["valid"], lin["dst"].to(torch.int64) // hl, d)
            _, order = torch.sort(shard_of, dim=1, stable=True)
            buckets, over[i] = _shard_buckets(
                {k: _take(v, order) for k, v in lin.items()},
                torch.gather(shard_of, 1, order), d, cap)
            sent.append(buckets)
        recv = [
            {k: torch.cat([sent[i][k][:, j].to(dev) for i in range(d)], dim=1)
             for k in _OUTBOX_FIELDS}
            for j, dev in enumerate(shards.devices)
        ]
    else:
        recv = [
            {k: torch.cat([lin[k].to(dev) for lin in lines], dim=1) for k in _OUTBOX_FIELDS}
            for dev in shards.devices
        ]
    lanes = cfg.deliver_lanes if cfg is not None else 0
    out = []
    for j, c in enumerate(cells):
        queue = _land(c, recv[j], j, hl, equeue.push_many_sorted,
                      deliver_lanes=lanes if lanes > 0 else c.queue.capacity)
        out.append(_replace(c, queue=queue, outbox=_fresh_outbox(c.outbox, over[j])))
    return out


def _flush_shards_segment(cells: list, cfg: EngineConfig, shards) -> list:
    """The segment exchange over a world's shards: each shard pools its
    outbox (_segment_pool), buckets the pool by destination shard (the
    pool is destination-sorted, so the buckets fall out of the same rank
    arithmetic as the dense all_to_all's) into a2a_capacity slots per
    peer (<= 0: the whole pool), and the buckets move over the ring;
    the pool's cut-off and the bucket overflow count into the outbox
    overflow of the sending shard's first row."""
    d, hl = shards.size, shards.hosts_per_shard
    sent, over = [], []
    for c in cells:
        pool, e_max, pool_drop = _segment_pool(c, cfg)
        cap = e_max if cfg.a2a_capacity <= 0 else min(cfg.a2a_capacity, e_max)
        shard_of = torch.where(pool["valid"], pool["dst"].to(torch.int64) // hl, d)
        buckets, ring_over = _shard_buckets(pool, shard_of, d, cap)
        sent.append(buckets)
        over.append(ring_over if pool_drop is None else ring_over + pool_drop)
    recv = _ring_exchange(sent, shards)
    return [
        _replace(c, queue=_land(c, recv[j], j, hl, equeue.push_many_segment),
                 outbox=_fresh_outbox(c.outbox, over[j]))
        for j, c in enumerate(cells)
    ]


def _compact_rows(st: SimState, window_end, lanes: int):
    """The live-lane permutation of active-set compaction: lane i of a
    world takes the world's i-th row whose next event is inside its
    window. Returns (rows, live): `rows` ([R * lanes], or [lanes] for one
    world) indexes the gather, replica-major, and a sentinel lane (a
    world with fewer eligible rows than lanes) points at the world's
    last row; `live` marks the real lanes."""
    worlds = replicas_of(st) or 1
    h_world = st.num_hosts // worlds
    elig = (equeue.next_time(st.queue) < per_row(st, window_end)).reshape(worlds, h_world)
    pos = torch.cumsum(elig.to(torch.int64), dim=1) - 1
    lane = torch.where(elig & (pos < lanes), pos, lanes)  # lane `lanes`: not taken
    rows = torch.full((worlds, lanes + 1), h_world, dtype=torch.int64, device=st.device)
    cols = torch.arange(h_world, device=st.device).expand(worlds, h_world)
    rows = rows.scatter(1, lane, cols)[:, :lanes]
    live = rows < h_world
    first = torch.arange(worlds, device=st.device)[:, None] * h_world
    return (torch.clamp(rows, max=h_world - 1) + first).reshape(-1), live.reshape(-1)


def gather_lanes(st: SimState, window_end, lanes: int):
    """The compacted sub-state of one iteration: `lanes` rows a world
    (replica-major on an ensemble's rows), per-world leaves taken whole,
    sentinel lanes' head times at TIME_MAX. Returns (sub, rows, live)
    with _compact_rows' gather index and live mask."""
    rows, live = _compact_rows(st, window_end, lanes)
    sub = map_host_leaves(lambda a: a.index_select(0, rows), st)
    q = sub.queue
    return _replace(sub, queue=_replace(q, head_time=_W(live, q.head_time, TIME_MAX))), rows, live


def compact_step(st: SimState, window_end, lanes: int, body) -> SimState:
    """Active-set compaction around one drain-iteration body: gather the
    rows of at most `lanes` hosts per world whose next event is inside
    the window into a sub-state (per-world leaves taken whole), run
    `body` there, and write the live lanes back. Hosts are independent
    inside a window, so handling a subset per iteration gives each host
    the same event sequence. A sentinel lane's head time is forced to
    TIME_MAX, which keeps it inert in every body (the kernel gates on it
    too), and it is never written back."""
    sub, rows, live = gather_lanes(st, window_end, lanes)
    sub = body(sub)
    keep = live.nonzero()[:, 0]
    back = rows.index_select(0, keep)
    return map_host_leaves(lambda full, g: full.index_copy(0, back, g.index_select(0, keep)),
                           st, sub)


def effective_engine(cfg: EngineConfig, device) -> str:
    """The engine an "auto" config runs: the megakernel when the state
    lives on the card, else the pump when pump_k > 0, else plain. An
    explicit engine name always wins."""
    if cfg.engine != "auto":
        return cfg.engine
    if torch.device(device).type == "cuda":
        return "megakernel"
    return "pump" if cfg.pump_k > 0 else "plain"


def run_round(st, window_end, model, tables: RoutingTables,
              cfg: EngineConfig, counters=None, live=None, shards=None):
    """Drain all events < window_end on every host, then exchange packets.
    `counters` (a dict) gains "iters" when given.

    On an ensemble's rows view, window_end is [R] and each replica drains
    on its own predicate: once it has no eligible row it is frozen (its
    rows take no further iteration and count none), and after a pump
    stage the handler pass runs only on the rows of replicas that
    rejected an event. `live` ([R] bool) names the replicas whose chunk
    loop runs this round; the others' tracker marks stay as they were
    (they have no eligible event and no traffic, so nothing else of
    theirs changes).

    With `shards` (a ShardContext), `st` is the list of one world's (or
    one mesh row's) shard states, `tables` the list of their devices'
    tables, and window_end and live are on shards.devices[0]: each shard
    drains its own rows on its own device with its own loop, as each
    device of the reference's shard_map does, and the exchange is the
    one step that crosses shards."""
    if shards is None:
        st, iters = _drain(st, window_end, model, tables, cfg, counters, live)
        st = flush_outbox(st, cfg)
        return _close_round(st, window_end, cfg, iters, live)
    ends, lives = shards.scatter(window_end), shards.scatter(live)
    drained = [_drain(c, ends[j], model, tables[j], cfg, counters, lives[j])
               for j, c in enumerate(st)]
    cells = flush_outbox([c for c, _ in drained], cfg, shards)
    return [_close_round(c, ends[j], cfg, drained[j][1], lives[j])
            for j, c in enumerate(cells)]


def _drain(st: SimState, window_end, model, tables: RoutingTables, cfg: EngineConfig,
           counters=None, live=None):
    """The drain loop of run_round on one state (a world, an ensemble's
    rows view, or one shard of either), with the tracker's pre-exchange
    marks. Returns (state, iterations): an int for one world, each
    replica's count ([R] i32) on an ensemble's rows."""
    replicas = replicas_of(st)
    h_world = st.num_hosts // (replicas or 1)
    lanes = cfg.active_lanes
    compact = 0 < lanes < h_world
    # a compacted iteration handles at most `lanes` hosts of a world, so
    # the cap on a round's work scales by the waves it splits into
    max_iters = cfg.max_iters_per_round
    if compact:
        max_iters *= -(-h_world // lanes)
    eng = effective_engine(cfg, st.device)
    stage, stage_cfg = None, cfg
    if model_pump_capable(model):
        if eng == "megakernel":
            from shadow_tpu_torch.engine.megakernel import (
                megakernel_stage,
                resolve_stage_cfg,
            )

            stage, stage_cfg = megakernel_stage, resolve_stage_cfg(cfg)
        elif eng == "pump" and cfg.pump_k > 0:
            from shadow_tpu_torch.engine.pump import pump_stage

            stage = pump_stage

    def body(s):
        """One iteration over the rows `s` holds (all, or a compacted
        sub-state): the pump stage, then the handler where some row
        rejected its head event (on an ensemble, on the rows of the
        replicas that rejected one); the plain handler without a stage."""
        if stage is None:
            return handle_one_iteration(s, window_end, model, tables, cfg)
        s, rej = stage(s, window_end, model, tables, stage_cfg)
        if bool(rej.any()):
            rows = None if replicas is None else per_row(s, rej)
            s = handle_one_iteration(s, window_end, model, tables, cfg, rows=rows)
        return s

    we_rows = per_row(st, window_end)
    iters = 0
    # each replica's own iteration count (an ensemble's done-mask)
    iters_r = None if replicas is None else torch.zeros(
        replicas, dtype=torch.int32, device=st.device)
    while iters < max_iters:
        elig = equeue.next_time(st.queue) < we_rows
        if replicas is None:
            if not bool(elig.any()):
                break
        else:
            going = per_replica(st, elig).any(dim=1)
            if not bool(going.any()):
                break
            iters_r += going.to(torch.int32)
        st = _replace(st, lanes_live=st.lanes_live + elig.to(torch.int64))
        st = compact_step(st, window_end, lanes, body) if compact else body(st)
        iters += 1
    if counters is not None:
        counters["iters"] = counters.get("iters", 0) + iters
    if cfg.tracker:
        tr = st.tracker
        exch = tr.exch_hwm.clone()
        if replicas is None:
            exch[0] = torch.maximum(exch[0], st.outbox.fill.sum().to(torch.int32))
        else:
            e0 = per_replica(st, exch)[:, 0]
            fill = per_replica(st, st.outbox.fill).sum(dim=1).to(torch.int32)
            per_replica(st, exch)[:, 0] = torch.maximum(e0, fill)
        st = _replace(
            st,
            tracker=_replace(
                tr,
                outbox_hwm=torch.maximum(tr.outbox_hwm, st.outbox.fill),
                queue_hwm=_queue_hwm(st, tr, live),
                exch_hwm=exch,
            ),
        )
    return st, (iters if replicas is None else iters_r)


def _queue_hwm(st: SimState, tr, live):
    hwm = torch.maximum(tr.queue_hwm, st.queue.count)
    if live is None:
        return hwm
    return _W(per_row(st, live), hwm, tr.queue_hwm)


def _close_round(st: SimState, window_end, cfg: EngineConfig, iters, live) -> SimState:
    """The end of run_round after the exchange: the queue high-water mark
    of the landed packets, the iteration count on each world's first
    row, and `now` at the window end."""
    if cfg.tracker:
        st = _replace(st, tracker=_replace(st.tracker, queue_hwm=_queue_hwm(st, st.tracker, live)))
    iters_done = st.iters_done.clone()
    if replicas_of(st) is None:
        iters_done[0] += iters
    else:
        per_replica(st, iters_done)[:, 0] += iters
    return _replace(st, now=torch.maximum(st.now, window_end), iters_done=iters_done)


def _lookahead_bound(st: SimState, tables: RoutingTables):
    """The adaptive window's bound on one state: min over its rows of
    (next event + the host's node lookahead), per world on an ensemble's
    rows."""
    nt = equeue.next_time(st.queue)
    la = tables.lookahead_ns[tables.host_node[st.host_id.to(torch.int64)].to(torch.int64)]
    bound = nt + torch.minimum(la, TIME_MAX - nt)
    return bound.amin() if replicas_of(st) is None else per_replica(st, bound).amin(dim=1)


def _next_window_end(st, end_time: int, cfg: EngineConfig, start,
                     tables: "RoutingTables | None" = None, shards=None):
    """The round's window end (an i64 scalar tensor; [R] on an
    ensemble's rows view, from each replica's own start and hosts):
    start + runahead, widened adaptively to min over hosts of (next
    event + node lookahead), capped at end_time. With `shards`, `st` and
    `tables` are the lists of a world's shard states and their tables,
    and the shards' least used latency and lookahead bound are reduced
    over the shards (the reference's pmins), on shards.devices[0]."""
    start = torch.clamp(start, max=end_time)
    runahead = cfg.runahead_ns
    if cfg.use_dynamic_runahead:
        # the window is the least latency a packet has used (never below
        # the configured runahead); before any packet flew, the runahead
        used = st.min_used_lat if shards is None else shards.pmin(
            [c.min_used_lat for c in st])
        runahead = _W(used == TIME_MAX, runahead, torch.clamp(used, min=runahead))
    floor = torch.clamp(start + runahead, max=end_time)
    # adaptive windows are off under dynamic runahead, where the delivery
    # clamp to the window end binds and a wider window would move
    # delivery times
    one = tables if shards is None else (tables[0] if tables else None)
    adaptive = (
        cfg.adaptive_window
        and not cfg.use_dynamic_runahead
        and one is not None
        and one.lookahead_ns is not None
        and one.host_node is not None
    )
    if not adaptive:
        return floor
    if shards is None:
        w = _lookahead_bound(st, tables)
    else:
        w = shards.pmin([_lookahead_bound(c, t) for c, t in zip(st, tables)])
    return torch.maximum(floor, torch.clamp(w, max=end_time))


def validate_runahead(cfg: EngineConfig, tables: RoutingTables) -> None:
    min_lat = tables.min_path_latency_ns()
    if cfg.runahead_ns > min_lat:
        raise ValueError(
            f"runahead_ns={cfg.runahead_ns} exceeds the minimum path latency "
            f"{min_lat}ns; use runahead_ns <= graph.min_latency_ns()"
        )


PROBE_FIELDS = (
    "next_time", "overflow", "now", "events_handled", "packets_sent",
    "queue_overflow", "outbox_overflow", "ev_local", "ev_tcp", "drop_loss",
    "drop_codel", "drop_unroutable", "bytes_ctrl", "bytes_data", "retrans_segs",
    "queue_hwm", "outbox_hwm", "rounds_live", "rounds_idle", "iters", "lanes_live",
    "win_ns_sum", "exch_hwm",
)


# probe lanes the reference reduces over a mesh axis by pmin or pmax; the
# rest by psum
_PROBE_MIN = ("next_time",)
_PROBE_MAX = ("now", "queue_hwm", "outbox_hwm", "exch_hwm", "rounds_live", "rounds_idle",
              "win_ns_sum")


def state_probe(st, shards=None) -> torch.Tensor:
    """[23] i64 summary the chunk loop reads (one fetch per chunk), the
    reference's lanes in its order: min pending time, total/queue/outbox
    overflow, now, events, packets, the tracker's per-kind events, the
    drop reasons, the tracker's byte classes and retransmissions, its
    queue and outbox high-water marks, the round counters, the drain
    iterations, the live lanes, the summed window widths and the
    exchange high-water mark (the tracker's lanes are 0 without
    cfg.tracker). An ensemble state (stacked or rows view) gives [R, 23],
    one line per replica. With `shards`, `st` is the list of a world's
    shard states and each lane is reduced over them as the reference
    reduces it over its mesh axis (min, max, else sum), on
    shards.devices[0]."""
    if shards is not None:
        lines = shards.gather([state_probe(c) for c in st])
        out = lines.sum(dim=0)
        for names, fn in ((_PROBE_MIN, torch.amin), (_PROBE_MAX, torch.amax)):
            for name in names:
                i = PROBE_FIELDS.index(name)
                out[..., i] = fn(lines[..., i], dim=0)
        return out
    single = replicas_of(st) is None

    def red(x, fn):
        return fn(x) if single else fn(per_replica(st, x), dim=1)

    def total(x):
        return red(x, torch.sum).to(torch.int64)

    def peak(x):
        return red(x, torch.amax).to(torch.int64)

    tr = st.tracker
    qov = total(st.queue.overflow)
    oov = total(st.outbox.overflow)
    return torch.stack(
        [
            red(equeue.next_time(st.queue), torch.amin),
            qov + oov,
            st.now,
            total(st.events_handled),
            total(st.packets_sent),
            qov,
            oov,
            total(tr.ev_local),
            total(tr.ev_tcp),
            total(st.packets_dropped),
            total(st.net.codel_dropped),
            total(st.packets_unroutable),
            total(tr.bytes_ctrl),
            total(tr.bytes_data),
            total(tr.retrans_segs),
            peak(tr.queue_hwm),
            peak(tr.outbox_hwm),
            tr.rounds_live,
            tr.rounds_idle,
            total(st.iters_done),
            total(st.lanes_live),
            st.win_ns_sum,
            peak(tr.exch_hwm),
        ],
        dim=-1,
    )


@dataclasses.dataclass(frozen=True)
class ChunkProbe:
    """Host-side view of one fetched probe (plain ints), one field per
    PROBE_FIELDS lane. This is what `on_chunk` callbacks, the tracker,
    the flight recorder and the state tap (runtime/checkpoint.py
    StateTap) receive: progress, heartbeat, metrics and checkpoint
    cadence read these fields instead of syncing on the state."""

    next_time: int
    overflow: int
    now: int
    events_handled: int
    packets_sent: int
    queue_overflow: int
    outbox_overflow: int
    ev_local: int
    ev_tcp: int
    drop_loss: int
    drop_codel: int
    drop_unroutable: int
    bytes_ctrl: int
    bytes_data: int
    retrans_segs: int
    queue_hwm: int
    outbox_hwm: int
    rounds_live: int
    rounds_idle: int
    iters: int
    lanes_live: int
    win_ns_sum: int
    exch_hwm: int

    @property
    def ev_packet(self) -> int:
        """Packet events handled (total minus the local/tcp classes)."""
        return self.events_handled - self.ev_local - self.ev_tcp

    @property
    def window_ns_mean(self) -> float:
        """Mean simulated width of the live windows drained so far (0.0
        without cfg.tracker, whose rounds_live is the denominator)."""
        return self.win_ns_sum / self.rounds_live if self.rounds_live else 0.0

    def occupancy(self, num_hosts: int, num_shards: int = 1) -> float:
        """Mean fraction of host lanes holding an eligible event per drain
        iteration. `iters` sums the loop counts of `num_shards` planes
        (the replicas of an ensemble), each scanning num_hosts/num_shards
        lanes."""
        denom = self.iters * (num_hosts // max(num_shards, 1))
        return self.lanes_live / denom if denom else 0.0

    @classmethod
    def from_array(cls, arr) -> "ChunkProbe":
        return cls(*(int(x) for x in arr))


class CapacityError(RuntimeError):
    """Fixed-slot capacity exhausted — user-remediable via config, or
    recoverable in place via rollback-and-regrow (runtime/recovery.py).
    Instances carry the overflow split as attributes so recovery can
    target the saturated buffer without parsing the message:
    queue_overflow / outbox_overflow / queue_hwm / outbox_hwm (ints, 0
    when unknown), the saturated buffers' bytes now and after a x2
    regrow, and, on an ensemble, the replica whose probe line carried the
    overflow.

    The top destination hosts (`shard_detail`, capacity_topk) are those
    of the state the reference's pipelined chunk loop has in flight, one
    chunk past the failing one; the port's chunk loop runs that chunk
    only when the message or the detail is first read (`detail_of`), so
    a recovery, which reads neither, does not pay for it."""

    queue_overflow: int = 0
    outbox_overflow: int = 0
    queue_hwm: int = 0
    outbox_hwm: int = 0
    bytes_current: int = 0
    bytes_regrown: int = 0
    exchange_hwm: int = 0
    replica: "int | None" = None
    _shard_detail: "str | None" = None
    # a callable giving the detail line, run once on the first read
    detail_of = None

    def _resolve_detail(self) -> None:
        fn, self.detail_of = self.detail_of, None
        if fn is None:
            return
        try:
            detail = fn()
        except Exception:  # noqa: BLE001 — diagnostics must not mask the error
            return
        if detail:
            self._shard_detail = detail
            self.args = (f"{self.args[0]}\n{detail}",) + self.args[1:]

    @property
    def shard_detail(self) -> "str | None":
        self._resolve_detail()
        return self._shard_detail

    def __str__(self) -> str:
        self._resolve_detail()
        return super().__str__()


class RunInterrupted(RuntimeError):
    """The run was stopped by SIGINT/SIGTERM (runtime/checkpoint.py
    InterruptGuard): the chunk loop committed a final checkpoint (when one
    could be verified clean) before raising. The partial state is not
    returned; resume from the checkpoint instead."""


class WatchdogExpired(RuntimeError):
    """A chunk's launch and probe fetch exceeded the configured watchdog
    deadline (experimental.chunk_watchdog_s). The chunk is abandoned;
    runtime/recovery.py rolls back to the retained clean snapshot and
    re-dispatches, counting it like a recovery in sim-stats. Past the
    recovery budget it propagates as a structured failure, never an
    indefinite hang."""

    def __init__(self, chunk: int, deadline_s: float):
        super().__init__(
            f"chunk {chunk} dispatch exceeded the {deadline_s:.3g}s "
            "watchdog deadline; abandoning the in-flight chunk"
        )
        self.chunk = chunk
        self.deadline_s = deadline_s


class DeviceLossError(RuntimeError):
    """A device (or the runtime under it) failed mid-run: a chunk's probe
    read died with a CUDA runtime error that plausibly means the card is
    gone (device_loss_from), or the chaos plane's `device-loss` fault
    fired at a chunk launch. Recoverable on the mesh by degradation
    (runtime/recovery.py's replan rung, runtime/mesh.py MeshRunner): roll
    back to the retained snapshot, re-plan the batch onto the surviving
    logical devices, replay leaf-exact. Outside the mesh it is terminal
    but structured. `device_id` is the lost logical device's id when
    known (a fault's target=N names it); `injected` marks the chaos
    plane's loss. On one card every logical device shares its fate: a
    real loss there takes them all, and only an injected loss can be
    degraded onto survivors."""

    def __init__(self, chunk: int, cause: "BaseException | None" = None,
                 device_id: "int | None" = None):
        detail = f": {cause}" if cause is not None else " (chaos plane)"
        dev = f"device {device_id}" if device_id is not None else "a device"
        super().__init__(f"lost {dev} at chunk {chunk}{detail}")
        self.chunk = chunk
        self.device_id = device_id
        self.injected = cause is None


# The CUDA runtime's texts (cudaGetErrorString) for failures that
# plausibly mean the card or its runtime died: the allowlist the
# translation below keys on, the counterpart of the reference's XLA
# status prefixes (INTERNAL, UNAVAILABLE, ABORTED, CANCELLED, UNKNOWN).
# Anything else surfaces as itself: out of memory (fewer devices make it
# worse), invalid arguments, an illegal address or a device-side assert
# (a kernel fault, which a replay would only repeat), a launch timeout.
_DEVICE_LOSS_ERRORS = (
    "unspecified launch failure",
    "uncorrectable ECC error encountered",
    "uncorrectable NVLink error",
    "CUDA-capable device(s) is/are busy or unavailable",
    "no CUDA-capable device is detected",
    "unknown error",
)


def device_loss_from(err: BaseException, chunk: int) -> "DeviceLossError | None":
    """Translate an exception raised by a chunk's probe read into a
    DeviceLossError when it is a CUDA runtime failure
    (torch.AcceleratorError, never a plain RuntimeError) whose text names
    one of _DEVICE_LOSS_ERRORS, else None (the caller re-raises the
    original). A DeviceLossError is returned as itself."""
    if isinstance(err, DeviceLossError):
        return err
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(err, accel):
        head = str(err).lstrip().split("\n", 1)[0]
        if head.startswith("CUDA error: "):
            head = head[len("CUDA error: "):]
        if any(head.startswith(text) for text in _DEVICE_LOSS_ERRORS):
            return DeviceLossError(chunk, cause=err)
    return None


class EngineCompileError(RuntimeError):
    """The selected engine failed to build its chunk program. The engines
    are leaf-exact, so this is recoverable by degradation:
    runtime/chaos.py run_with_engine_ladder falls one rung (megakernel ->
    pump -> plain); only a plain-engine failure is terminal. In the port
    only the chaos plane's injected `compile` fault raises it
    (runtime/chaos.py compile_seam): a real build or launch failure of
    the kernel propagates as itself."""

    def __init__(self, engine: str, cause: "BaseException | None" = None):
        super().__init__(
            f"{engine} engine failed to compile its chunk program: "
            f"{cause if cause is not None else 'injected fault (chaos plane)'}"
        )
        self.engine = engine


def _capacity_error(
    dropped: int,
    queue_ov: "int | None" = None,
    outbox_ov: "int | None" = None,
    queue_hwm: "int | None" = None,
    outbox_hwm: "int | None" = None,
    exch_hwm: "int | None" = None,
) -> CapacityError:
    """The reference's capacity error: the split names which fixed-slot
    counter saturated; the high-water marks (tracker plane, nonzero only
    with cfg.tracker) say how close to the rim the other one ran, and
    the exchange high-water the pool occupancy an exchange-side drop was
    up against."""
    if queue_ov is None:
        which = "queue.overflow/outbox.overflow"
    else:
        sat = [
            name
            for name, n in (("queue", queue_ov), ("outbox/exchange", outbox_ov))
            if n
        ]
        which = (
            f"saturated: {' + '.join(sat) or 'unknown'} "
            f"[queue.overflow={queue_ov}, outbox.overflow={outbox_ov}"
        )
        if queue_hwm or outbox_hwm:
            which += f"; high-water queue={queue_hwm}, outbox={outbox_hwm}"
        if exch_hwm:
            which += f"; exchange pool occupancy hwm={exch_hwm} events/round"
        which += "]"
    err = CapacityError(
        f"event capacity exhausted: {dropped} events/packets dropped "
        f"({which}); increase queue_capacity/"
        f"outbox_capacity — or, for sharded all_to_all runs with "
        f"pair-skewed destinations, set a2a_capacity=-1 (whole-outbox "
        f"buckets, never overflow); segment-exchange runs "
        f"(exchange='segment') raise the pool with pool_capacity "
        f"(0 = whole outbox, never truncates)"
    )
    err.queue_overflow = int(queue_ov or 0)
    err.outbox_overflow = int(outbox_ov or 0)
    err.queue_hwm = int(queue_hwm or 0)
    err.outbox_hwm = int(outbox_hwm or 0)
    err.exchange_hwm = int(exch_hwm or 0)
    return err


def _probe_capacity_error(probe: ChunkProbe) -> CapacityError:
    return _capacity_error(
        probe.overflow, queue_ov=probe.queue_overflow, outbox_ov=probe.outbox_overflow,
        queue_hwm=probe.queue_hwm, outbox_hwm=probe.outbox_hwm, exch_hwm=probe.exch_hwm,
    )


def attach_capacity_bytes(err: CapacityError, st) -> None:
    """Price the saturated buffer(s) now and after the x2 regrow recovery
    would apply, from the live state's shapes (no device sync), and
    render the figures next to the high-water marks. Best-effort:
    diagnostics never mask the error. Works on single and ensemble
    states alike (the capacity axis is keyed off the per-host counters'
    rank)."""
    from shadow_tpu_torch.engine.state import buffer_nbytes, fmt_bytes

    try:
        cur = grown = 0
        for sub, counts, saturated in (
            (st.queue, st.queue.count, err.queue_overflow),
            (st.outbox, st.outbox.fill, err.outbox_overflow),
        ):
            if not saturated:
                continue
            base = counts.dim()
            cur += buffer_nbytes(sub, base)
            grown += buffer_nbytes(sub, base, scale=2.0)
        if not cur:
            return
        err.bytes_current = int(cur)
        err.bytes_regrown = int(grown)
        err.args = (
            f"{err.args[0]}\n  saturated buffer bytes: {fmt_bytes(cur)} now, "
            f"{fmt_bytes(grown)} after the x2 regrow",
        ) + err.args[1:]
    except Exception:  # noqa: BLE001 — diagnostics must not mask the error
        pass


def capacity_topk(st: SimState, k: int = 5) -> str:
    """Failure-path diagnostic: the top-k destination hosts by landed
    events (queue occupancy / overflow / high-water), one bulk fetch of
    the [H] counters, naming where the landing side saturated."""
    cnt, ov, hwm, hid = (
        t.detach().cpu().numpy()
        for t in (st.queue.count, st.queue.overflow, st.tracker.queue_hwm, st.host_id)
    )
    score = ov.astype(np.int64) * 1_000_000 + np.maximum(
        hwm.astype(np.int64), cnt.astype(np.int64)
    )
    order = np.argsort(-score, kind="stable")[:k]
    rows = [
        f"host {int(hid[i])} (count={int(cnt[i])}, overflow={int(ov[i])}, "
        f"hwm={int(hwm[i])})"
        for i in order
        if score[i] > 0
    ]
    if not rows:
        return ""
    return "top destination hosts by landed events: " + "; ".join(rows)


def check_capacity(st: SimState) -> None:
    """Fail loudly if fixed-slot capacity was exhausted (on an ensemble,
    naming the first replica that exhausted it)."""
    rows = state_probe(st).cpu().numpy()
    if replicas_of(st) is not None:
        if rows[:, PROBE_FIELDS.index("overflow")].any():
            from shadow_tpu_torch.engine.ensemble import _replica_capacity_error

            raise _replica_capacity_error(rows)
        return
    probe = ChunkProbe.from_array(rows)
    if probe.overflow:
        err = _probe_capacity_error(probe)
        attach_capacity_bytes(err, st)
        raise err


def host_stats(st: SimState) -> dict:
    """ONE bulk fetch of every per-host stat/tracker tensor, as numpy
    ([R, H] per-host arrays and [R] round counters for a stacked
    ensemble state)."""
    t = st.tracker
    fields = {
        "host_id": st.host_id,
        "events_handled": st.events_handled,
        "packets_sent": st.packets_sent,
        "packets_dropped": st.packets_dropped,
        "packets_unroutable": st.packets_unroutable,
        "codel_dropped": st.net.codel_dropped,
        "bytes_sent": st.net.bytes_sent,
        "bytes_recv": st.net.bytes_recv,
        "ev_local": t.ev_local,
        "ev_tcp": t.ev_tcp,
        "bytes_ctrl": t.bytes_ctrl,
        "bytes_data": t.bytes_data,
        "retrans_segs": t.retrans_segs,
        "queue_hwm": t.queue_hwm,
        "outbox_hwm": t.outbox_hwm,
        "rounds_live": t.rounds_live,
        "rounds_idle": t.rounds_idle,
        "exch_hwm": t.exch_hwm,
        "iters_done": st.iters_done,
        "lanes_live": st.lanes_live,
        "win_ns_sum": st.win_ns_sum,
    }
    return {k: np.asarray(v.detach().cpu().numpy()) for k, v in fields.items()}


def _run_chunk(st: SimState, end_time: int, model, tables: RoutingTables, cfg: EngineConfig,
               rounds_per_chunk: int, counters=None) -> SimState:
    """`rounds_per_chunk` rounds of the chunk loop: each picks its window
    and drains it; once no host has work before end_time and no packet
    is staged, this and every later round of the chunk take the idle
    branch (only `now` and the idle-round counter move)."""
    end_t = torch.tensor(end_time, dtype=torch.int64, device=st.device)
    for r in range(rounds_per_chunk):
        start = equeue.next_time(st.queue).amin()
        has_traffic = st.outbox.valid.any()
        window_end = _next_window_end(st, end_time, cfg, start, tables)
        live = bool(((start < end_t) | has_traffic).item())
        if not live:
            idle = rounds_per_chunk - r
            st = _replace(st, now=torch.maximum(st.now, window_end))
            if cfg.tracker:
                st = _replace(
                    st,
                    tracker=_replace(st.tracker, rounds_idle=st.tracker.rounds_idle + idle),
                )
            break
        width = window_end - torch.minimum(start, window_end)
        st = _replace(st, win_ns_sum=st.win_ns_sum + width)
        st = run_round(st, window_end, model, tables, cfg, counters)
        if cfg.tracker:
            st = _replace(
                st,
                tracker=_replace(st.tracker, rounds_live=st.tracker.rounds_live + 1),
            )
    return st


def tap_chunk(on_state, probe: ChunkProbe, chunk: int, st, launch, snapshot,
              pending: bool, ahead: bool) -> bool:
    """One chunk boundary of a chunk loop's state tap (run_until,
    run_ensemble_until), after `probe` passed its overflow check: commit
    the snapshot left pending at the last boundary (this chunk's state,
    now verified), then ask `on_state` whether a snapshot is due or an
    interrupt came. With the reference's next chunk in flight (`ahead`),
    a due snapshot is that chunk's and waits for its probe (the returned
    pending flag); on an interrupt no probe will verify it, so its own
    overflow counters decide whether it is committed before
    RunInterrupted. `snapshot(st)` makes the host copy."""
    if pending:
        on_state.commit(snapshot(st))
        pending = False
    interrupted = on_state.interrupted()
    if on_state.due(probe, chunk) or interrupted:
        if not ahead:
            on_state.commit(snapshot(st))
        elif interrupted:
            host = snapshot(launch(st))
            if not (host[".queue.overflow"].any() or host[".outbox.overflow"].any()):
                on_state.commit(host)
        else:
            pending = True
    if interrupted:
        raise RunInterrupted(f"run interrupted at sim time {probe.now} ns")
    return pending


def _tspan(tracker, name, **args):
    """A tracker span, or a no-op when no tracker is attached (the hot
    path pays one `if`)."""
    if tracker is None:
        return contextlib.nullcontext()
    return tracker.span(name, **args)


# helpers abandoned at a deadline, with it: joined at exit (below)
_ABANDONED: "list[tuple[threading.Thread, float]]" = []


@atexit.register
def _join_abandoned() -> None:
    """Give each abandoned chunk another deadline to end before the
    interpreter exits: a helper still in a torch call when the runtime
    is torn down aborts the process, and the run's own error and exit
    code would be lost. One wedged for good is left behind."""
    for helper, watchdog_s in _ABANDONED:
        helper.join(watchdog_s)


def _bounded(work, watchdog_s: float, t0: float, chunk_idx: int):
    """`work()` under the chunk watchdog's deadline, `t0 + watchdog_s`:
    it runs in a daemon helper thread joined with what is left of the
    deadline, so work that blocks on a wedged or slow stream surfaces as
    WatchdogExpired in the caller's thread instead of blocking it. The
    abandoned helper (a thread named `chunk-watchdog-N`) runs on to its
    end on the abandoned chunk's tensors; the replay starts from the
    retained host snapshot. An exception of `work` is raised in the
    caller's thread."""
    remaining = watchdog_s - (time.perf_counter() - t0)
    if remaining <= 0:
        raise WatchdogExpired(chunk_idx, watchdog_s)
    box: list = []

    def run():
        try:
            box.append((True, work()))
        except BaseException as e:  # surfaced in the caller's thread
            box.append((False, e))

    helper = threading.Thread(target=run, daemon=True, name=f"chunk-watchdog-{chunk_idx}")
    helper.start()
    helper.join(remaining)
    if not box:
        _ABANDONED.append((helper, watchdog_s))
        raise WatchdogExpired(chunk_idx, watchdog_s)
    ok, val = box[0]
    if not ok:
        raise val
    return val


def _fetch_probe(probe: torch.Tensor, watchdog_s: float, chunk_idx: int, t0: float) -> list:
    """Read a chunk's probe to the host, under the chunk watchdog when one
    is configured (watchdog_s > 0): the read runs in _bounded with the
    deadline measured from `t0` (run_chunk passes the start of the
    chunk's launch). The chaos plane's `stall` seam sleeps
    inside the measured region, before the read, as in the reference, so
    the watchdog is exercised deterministically. Watchdog off: the plain
    blocking read, no thread."""
    stall = chaos.fire("stall", at=chunk_idx)
    if stall is not None:
        time.sleep(stall.stall_s)
    if watchdog_s <= 0:
        return probe.tolist()
    return _bounded(probe.tolist, watchdog_s, t0, chunk_idx)


def observe_chunk(probe, chunk: int) -> None:
    """The seams after a chunk's probe is read: the installed flight
    recorder observes it (before the overflow check, so a post-mortem's
    last sample is the failing chunk), then the chaos plane's `capacity`
    fault for this chunk may fire."""
    flightrec.observe_probe(probe, chunk=chunk)
    injected = chaos.fire("capacity", at=chunk)
    if injected is not None:
        raise chaos.injected_capacity_error(chunk, injected)


def launch_chunk(launch, st, chunk: int, tracker, engine: str, model=None):
    """One chunk launch of a chunk loop, in its tracker span. Chunk 0 is
    where the engine's chunk program is first built (the kernel's nvcc
    build on the card, of the library for `model`'s TCP shape, done here
    before `launch` is called, so a watched launch's deadline does not
    count it, as the reference's compile is outside its deadline): it
    runs inside the chaos plane's compile seam, where only an injected
    `compile` fault becomes an EngineCompileError."""
    if chunk:
        with _tspan(tracker, "chunk_launch", chunk=chunk):
            return launch(st)
    with chaos.compile_seam(engine):
        with _tspan(tracker, "compile+launch", chunk=0):
            if engine == "megakernel" and st.device.type == "cuda":
                from shadow_tpu_torch.engine.megakernel import PUMP_KERNEL, tcp_shape

                PUMP_KERNEL.library(tcp_shape(model))
            return launch(st)


def run_chunk(launch, st, chunk: int, tracker, engine: str, watchdog_s: float,
              devices=None, max_chunks: "int | None" = None, model=None):
    """One chunk of a chunk loop (run_until, run_ensemble_until): its
    launch (launch_chunk), then its probe read in the `probe_fetch` span.
    Returns (state, probe as a list).

    `watchdog_s` > 0 arms the chunk watchdog. The port's launch runs the
    chunk's device work and waits on it (each round reads whether any
    host is live), where the reference's launch is asynchronous and its
    device work lands in the probe read; so the measured region starts
    when `launch` is called, and the launch and the read each run in
    _bounded against the one deadline. A chunk that is slow or wedged on
    the card raises WatchdogExpired; so does the `stall` seam's sleep
    between them. With the watchdog armed, spans that `launch` itself
    records (a heartbeat's host_stats_fetch) carry the helper thread's
    id.

    `devices` (the logical device ids the state occupies) arms the
    device-loss seams of the reference's ensemble and mesh driver: the
    chaos plane's `device-loss` fault at each chunk launch ordinal, the
    devices as the site's tags (a loss of a device the run does not
    occupy never fires), and device_loss_from on the probe read. The
    reference launches chunk N + 1 before it reads chunk N's probe, so
    ordinal N + 1 (while below `max_chunks`) is consulted here before
    this chunk's probe is read, ordinal 0 before chunk 0's launch."""
    t0 = 0.0

    def watched(s):
        nonlocal t0
        t0 = time.perf_counter()
        if watchdog_s <= 0:
            return launch(s)
        return _bounded(lambda: launch(s), watchdog_s, t0, chunk)

    def loss_seam(at):
        if devices is not None and chaos.active() is not None:
            spec = chaos.fire("device-loss", at=at, tags=tuple(str(d) for d in devices))
            if spec is not None:
                raise chaos.injected_device_loss(at, spec)

    if chunk == 0:
        loss_seam(0)
    st = launch_chunk(watched, st, chunk, tracker, engine, model)
    if max_chunks is None or chunk + 1 < max_chunks:
        loss_seam(chunk + 1)
    with _tspan(tracker, "probe_fetch", chunk=chunk):
        try:
            return st, _fetch_probe(state_probe(st), watchdog_s, chunk, t0)
        except (WatchdogExpired, RunInterrupted, KeyboardInterrupt):
            raise
        except Exception as err:
            # a card that died surfaces at the first read after a launch,
            # as a CUDA runtime error: the typed loss the mesh's
            # degradation rung acts on. Anything else is what it is.
            loss = device_loss_from(err, chunk) if devices is not None else None
            if loss is None:
                raise
            raise loss from err


def run_until(
    st: SimState,
    end_time: int,
    model,
    tables: RoutingTables,
    cfg: EngineConfig,
    rounds_per_chunk: int = 64,
    max_chunks: int = 10_000,
    on_chunk=None,
    counters=None,
    on_state=None,
    tracker=None,
    watchdog_s: float = 0.0,
    chunk=None,
    capacity_detail=None,
) -> SimState:
    """Host-side driver: chunks of `rounds_per_chunk` rounds until no work
    remains before end_time. The caller's state is never modified (the
    run works on a private copy). Rounds are grouped into chunks exactly
    as in the reference, whose probe is read once per chunk, because a
    chunk's trailing idle rounds are visible in `now` and the tracker's
    round counters. `on_chunk(probe: ChunkProbe)` sees each chunk's
    probe; `counters` (a dict) accumulates "iters".

    `on_state` (runtime/checkpoint.py StateTap) taps chunk-boundary
    states for checkpoints, recovery snapshots and interrupts, as the
    reference's `_drive` does: `due(probe, chunk)` decides from the
    probe, `commit(host)` receives a snapshot (state_to_host) that a
    probe has verified free of overflow, `interrupted()` asks for a stop
    (a final snapshot is committed, then RunInterrupted). The
    reference's pipelined chunk loop (`_drive`) launches the next chunk
    before it reads a probe, so the state it snapshots at a probe, and
    the state whose hosts a capacity error names (capacity_topk), is the
    next chunk's; a due snapshot waits for that chunk's own probe. This
    loop runs chunks one at a time and takes those same states: the next
    chunk's state once its probe passed, and one chunk more on the error
    and interrupt paths (the error's only when its text is read). So
    checkpoints and error texts equal the reference's.

    `tracker` (utils/tracker.py) records the reference's dispatch spans
    (donate_copy, compile+launch on chunk 0, where the kernel's first use
    builds it, chunk_launch, probe_fetch, host_stats_fetch,
    state_snapshot) and renders per-host heartbeat lines when it says one
    is due, deciding from the already-read probe. The reference renders
    the heartbeat of probe N from the chunk it has in flight, N + 1: this
    loop renders it after chunk N + 1 has run, stamped with probe N's
    `now` (from chunk N itself when no chunk follows, where the
    reference's extra chunk is idle). The installed flight recorder
    (runtime/flightrec.py) observes every probe before its overflow
    check, so a post-mortem's last sample is the failing chunk.

    `watchdog_s` > 0 arms the chunk watchdog (run_chunk): a chunk whose
    launch and probe read pass the deadline raises WatchdogExpired. The chaos plane's seams
    fire at the reference's sites and ordinals: `compile` at chunk 0's
    launch (for the engine this config runs here), `stall` in chunk N's
    probe read, `capacity` after chunk N's probe is observed. The
    reference's pipelined loop reads chunk N's probe with chunk N + 1 in
    flight, and names the sites by N as this loop does.

    `chunk` (a callable `chunk(st, end_time, tables, counters)` running
    rounds_per_chunk rounds, engine/sharded.py's GridChunk) replaces the
    single-device rounds, and `capacity_detail(st)` the capacity error's
    detail line (capacity_topk): the sharded engine's driver is this
    loop with its chunk and its per-shard detail."""
    from shadow_tpu_torch.engine.state import state_to_host

    validate_runahead(cfg, tables)
    if int(equeue.next_time(st.queue).amin()) >= end_time:
        check_capacity(st)
        return st
    with _tspan(tracker, "donate_copy"):
        st = st.clone()
    flightrec.begin_segment()

    def heartbeat(probe, src):
        with _tspan(tracker, "host_stats_fetch"):
            tracker.emit_host_heartbeat(probe, host_stats(src))

    hb_probe = None  # a heartbeat decided at the last probe, due from this chunk

    def launch(s):
        if chunk is None:
            out = _run_chunk(s, end_time, model, tables, cfg, rounds_per_chunk, counters)
        else:
            out = chunk(s, end_time, tables, counters)
        nonlocal hb_probe
        if hb_probe is not None:
            heartbeat(hb_probe, out)
            hb_probe = None
        return out

    def snapshot(s):
        with _tspan(tracker, "state_snapshot", chunk=chunks):
            return state_to_host(s)

    engine = effective_engine(cfg, st.device)
    chunks = 0
    pending = False  # a due snapshot of this chunk's state, verified by its probe
    while True:
        st, row = run_chunk(launch, st, chunks, tracker, engine, watchdog_s, model=model)
        chunks += 1
        probe = ChunkProbe.from_array(row)
        observe_chunk(probe, chunks - 1)
        # the reference's chunk loop has the next chunk in flight at this probe
        ahead = chunks < max_chunks
        if probe.overflow:
            err = _probe_capacity_error(probe)
            attach_capacity_bytes(err, st)  # shapes only: the next chunk's are the same
            detail = capacity_detail or capacity_topk
            err.detail_of = lambda s=st: detail(launch(s) if ahead else s)
            raise err
        if on_chunk is not None:
            on_chunk(probe)
        if tracker is not None and tracker.host_heartbeat_due(probe.now):
            if ahead and probe.next_time < end_time:
                hb_probe = probe  # rendered by the next launch
            else:
                heartbeat(probe, st)
        if on_state is not None:
            pending = tap_chunk(on_state, probe, chunks - 1, st, launch, snapshot,
                                pending, ahead)
        if probe.next_time >= end_time:
            return st
        if chunks >= max_chunks:
            raise RuntimeError(
                f"simulation did not reach end_time={end_time} within "
                f"{max_chunks}x{rounds_per_chunk} rounds; raise max_chunks/rounds_per_chunk"
            )
