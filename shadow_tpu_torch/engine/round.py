"""The conservative-PDES round engine (port of shadow_tpu/engine/round.py,
single device: the dense and segment exchanges, active-set compaction,
fixed, adaptive and dynamic runahead windows).

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
"""

from __future__ import annotations

import contextlib
import dataclasses

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
from shadow_tpu_torch.runtime import flightrec
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
    ctrs = (
        draw.counter[:, None]
        + model.DRAWS_PER_EVENT
        + torch.arange(ep, dtype=i64, device=dev)[None, :]
    ) & rng.MASK32
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

    stride = model.DRAWS_PER_EVENT + ep
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


def flush_outbox(st: SimState, cfg: "EngineConfig | None" = None) -> SimState:
    """Round-boundary exchange: deliver staged packets into destination
    queues (empty rounds skip the exchange entirely)."""
    if not bool(st.outbox.valid.any()):
        return st
    return _flush_outbox_traffic(st, cfg)


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


def _flush_outbox_traffic(st: SimState, cfg: "EngineConfig | None" = None) -> SimState:
    if cfg is not None and cfg.exchange == "segment":
        return _flush_segment(st, cfg)
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


def _flush_segment(st: SimState, cfg: EngineConfig) -> SimState:
    """The segment exchange (exchange="segment", single device): each
    world's staged entries sorted stably by (destination, time, tie),
    valid ones first, into a pool; the pool's first pool_capacity entries
    (0: the whole outbox, never truncating) land through
    equeue.push_many_segment, and the valid entries cut off count into
    the outbox overflow of the world's first row. On an ensemble's rows
    each replica has a pool of its own, as under the reference's vmap.
    Pop order equals the dense exchange's; slot placement differs."""
    ob = st.outbox
    h, o_cap = ob.valid.shape
    worlds = replicas_of(st) or 1
    h_world = h // worlds
    m = h_world * o_cap

    def per_world(x):
        return x.reshape((worlds, m) + tuple(x.shape[2:]))

    valid, dst = per_world(ob.valid), per_world(ob.dst)
    key = torch.where(valid, dst.to(torch.int64), 1 << 30)
    perm = _pool_order(key, per_world(ob.time), per_world(ob.tie))
    e_max = min(cfg.pool_capacity or m, m)
    perm = perm[:, :e_max]
    pool_drop = None
    if e_max < m:
        pool_drop = torch.clamp(valid.sum(dim=1) - e_max, min=0).to(torch.int32)

    def pool(x):
        x = per_world(x)
        idx = perm.reshape(perm.shape + (1,) * (x.dim() - 2)).expand(
            (worlds, e_max) + tuple(x.shape[2:]))
        return torch.gather(x, 1, idx).reshape((worlds * e_max,) + tuple(x.shape[2:]))

    valid_p, dst_p = pool(ob.valid), pool(ob.dst).to(torch.int64)
    mine = valid_p & (dst_p >= 0) & (dst_p < h_world)
    first_row = torch.arange(worlds * e_max, device=dst_p.device) // e_max * h_world
    queue = equeue.push_many_segment(
        st.queue,
        dst=dst_p + first_row,
        valid=mine,
        time=pool(ob.time),
        tie=pool(ob.tie),
        kind=torch.full((worlds * e_max,), KIND_PACKET, dtype=torch.int32, device=dst_p.device),
        data=pool(ob.data),
        aux=pool(ob.aux),
        rows_per_world=h_world,
    )
    return _replace(st, queue=queue, outbox=_fresh_outbox(ob, pool_drop))


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


def run_round(st: SimState, window_end, model, tables: RoutingTables,
              cfg: EngineConfig, counters=None, live=None) -> SimState:
    """Drain all events < window_end on every host, then exchange packets.
    `counters` (a dict) gains "iters" when given.

    On an ensemble's rows view, window_end is [R] and each replica drains
    on its own predicate: once it has no eligible row it is frozen (its
    rows take no further iteration and count none), and after a pump
    stage the handler pass runs only on the rows of replicas that
    rejected an event. `live` ([R] bool) names the replicas whose chunk
    loop runs this round; the others' tracker marks stay as they were
    (they have no eligible event and no traffic, so nothing else of
    theirs changes)."""
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

    def queue_hwm(tr):
        hwm = torch.maximum(tr.queue_hwm, st.queue.count)
        if live is None:
            return hwm
        return _W(per_row(st, live), hwm, tr.queue_hwm)

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
                queue_hwm=queue_hwm(tr),
                exch_hwm=exch,
            ),
        )
    st = flush_outbox(st, cfg)
    if cfg.tracker:
        st = _replace(st, tracker=_replace(st.tracker, queue_hwm=queue_hwm(st.tracker)))
    iters_done = st.iters_done.clone()
    if replicas is None:
        iters_done[0] += iters
    else:
        per_replica(st, iters_done)[:, 0] += iters_r
    return _replace(st, now=torch.maximum(st.now, window_end), iters_done=iters_done)


def _next_window_end(st: SimState, end_time: int, cfg: EngineConfig, start,
                     tables: "RoutingTables | None" = None):
    """The round's window end (an i64 scalar tensor; [R] on an
    ensemble's rows view, from each replica's own start and hosts):
    start + runahead, widened adaptively to min over hosts of (next
    event + node lookahead), capped at end_time."""
    start = torch.clamp(start, max=end_time)
    runahead = cfg.runahead_ns
    if cfg.use_dynamic_runahead:
        # the window is the least latency a packet has used (never below
        # the configured runahead); before any packet flew, the runahead
        used = st.min_used_lat
        runahead = _W(used == TIME_MAX, runahead, torch.clamp(used, min=runahead))
    floor = torch.clamp(start + runahead, max=end_time)
    # adaptive windows are off under dynamic runahead, where the delivery
    # clamp to the window end binds and a wider window would move
    # delivery times
    adaptive = (
        cfg.adaptive_window
        and not cfg.use_dynamic_runahead
        and tables is not None
        and tables.lookahead_ns is not None
        and tables.host_node is not None
    )
    if not adaptive:
        return floor
    nt = equeue.next_time(st.queue)
    la = tables.lookahead_ns[tables.host_node[st.host_id.to(torch.int64)].to(torch.int64)]
    bound = nt + torch.minimum(la, TIME_MAX - nt)
    w = bound.amin() if replicas_of(st) is None else per_replica(st, bound).amin(dim=1)
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


def state_probe(st: SimState) -> torch.Tensor:
    """[23] i64 summary the chunk loop reads (one fetch per chunk), the
    reference's lanes in its order: min pending time, total/queue/outbox
    overflow, now, events, packets, the tracker's per-kind events, the
    drop reasons, the tracker's byte classes and retransmissions, its
    queue and outbox high-water marks, the round counters, the drain
    iterations, the live lanes, the summed window widths and the
    exchange high-water mark (the tracker's lanes are 0 without
    cfg.tracker). An ensemble state (stacked or rows view) gives [R, 23],
    one line per replica."""
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
    check, so a post-mortem's last sample is the failing chunk."""
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
        out = _run_chunk(s, end_time, model, tables, cfg, rounds_per_chunk, counters)
        nonlocal hb_probe
        if hb_probe is not None:
            heartbeat(hb_probe, out)
            hb_probe = None
        return out

    def snapshot(s):
        with _tspan(tracker, "state_snapshot", chunk=chunks):
            return state_to_host(s)

    chunks = 0
    pending = False  # a due snapshot of this chunk's state, verified by its probe
    while True:
        with _tspan(tracker, "chunk_launch" if chunks else "compile+launch", chunk=chunks):
            st = launch(st)
        chunks += 1
        with _tspan(tracker, "probe_fetch", chunk=chunks - 1):
            probe = ChunkProbe.from_array(state_probe(st).tolist())
        flightrec.observe_probe(probe, chunk=chunks - 1)
        # the reference's chunk loop has the next chunk in flight at this probe
        ahead = chunks < max_chunks
        if probe.overflow:
            err = _probe_capacity_error(probe)
            attach_capacity_bytes(err, st)  # shapes only: the next chunk's are the same
            err.detail_of = lambda s=st: capacity_topk(launch(s) if ahead else s)
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
