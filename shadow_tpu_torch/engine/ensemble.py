"""Ensemble plane (port of shadow_tpu/engine/ensemble.py): R seeded
replicas of one world run as one batch.

Conclusions drawn from one seeded run of a network simulation are not
sound ("Once is Never Enough", Jansen et al., USENIX Security 2021); an
experiment runs many seeds. Here they run as one batch: every per-host
leaf of the state gains a leading replica axis [R, H, ...] and every
per-world leaf becomes [R], as the reference's stacked state has them,
and the engine computes on the [R * H, ...] rows of that stack
(engine/state.py::rows_view). Each drain iteration makes one handler
pass and, on the card, one launch of the pump kernel over all R * H
rows; there is no loop over replicas.

Independence is exact: replica r's keys are rng.replica_keys row r,
which is host_keys(seed + r * stride), and the seed enters the state
nowhere else, so replica r of the final state is leaf-identical to a
single run with that seed. What keeps the batch exact, as the
reference's vmap does:

  * per-replica windows: each replica's window end comes from its own
    hosts, and each row reads its own replica's (engine/round.py,
    the kernel and its twin);
  * per-replica done-mask: a replica with no eligible row is frozen for
    the rest of the round's drain (it takes no iteration and counts
    none), and after a pump stage the handler runs only on the rows of
    replicas that rejected an event (engine/round.py::run_round);
  * per-replica probe: the chunk probe is [R, lanes]; the driver stops
    when every replica is quiescent and restores each replica's `now`
    and round counters to its own quiescence chunk's probe line, which
    is where its single run would have stopped (_finish).

The megakernel stays the engine on the card: an ensemble of a model with
a kernel instance (tgen, onion) runs the kernel, and a kernel that fails
to build or launch raises (the reference falls back to its XLA pump
under vmap; the port carries no fallback).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from shadow_tpu_torch import equeue, rng
from shadow_tpu_torch.engine.round import (
    PROBE_FIELDS,
    ChunkProbe,
    _capacity_error,
    _next_window_end,
    _replace,
    _tspan,
    attach_capacity_bytes,
    bootstrap,
    check_capacity,
    run_round,
    state_probe,
    tap_chunk,
    validate_runahead,
)
from shadow_tpu_torch.engine.state import (
    EngineConfig,
    SimState,
    _grow,
    init_state,
    per_replica,
    rows_view,
    stacked_view,
    state_to_host,
)
from shadow_tpu_torch.graph.routing import RoutingTables
from shadow_tpu_torch.runtime import flightrec
from shadow_tpu_torch.utils.tree import tree_map

_LANE = {name: i for i, name in enumerate(PROBE_FIELDS)}
# probe lanes that aggregate across replicas by min or max; the rest sum
_MIN_LANES = ("next_time", "now")
_MAX_LANES = ("rounds_live", "rounds_idle", "queue_hwm", "outbox_hwm", "exch_hwm", "win_ns_sum")


def ensemble_engine_cfg(cfg: EngineConfig) -> EngineConfig:
    """The engine config an ensemble runs: cfg with ensemble=True. The
    engine is unchanged (the megakernel on the card when "auto")."""
    return dataclasses.replace(cfg, ensemble=True)


def replica_seeds(cfg: EngineConfig, num_replicas: int, stride: int = 1) -> "list[int]":
    """The derived seed of each replica: replica r of an ensemble is
    leaf-identical to a single run with this seed."""
    return [cfg.seed + r * stride for r in range(num_replicas)]


def init_ensemble_state(
    cfg: EngineConfig,
    model,
    num_replicas: int,
    seed_stride: int = 1,
    tx_bytes_per_interval=None,
    rx_bytes_per_interval=None,
    device="cuda",
) -> SimState:
    """The bootstrapped [R, ...] initial state: R single-world states built
    exactly as init_state + bootstrap build them for the derived seeds,
    stacked along a new leading replica axis."""
    if num_replicas < 1:
        raise ValueError("num_replicas must be >= 1")
    keys = rng.replica_keys(cfg.seed, num_replicas, cfg.num_hosts, seed_stride, device)
    states = []
    for r, seed in enumerate(replica_seeds(cfg, num_replicas, seed_stride)):
        rcfg = dataclasses.replace(cfg, seed=seed)
        st = init_state(
            rcfg,
            model.init(device),
            tx_bytes_per_interval=tx_bytes_per_interval,
            rx_bytes_per_interval=rx_bytes_per_interval,
            device=device,
        )
        states.append(bootstrap(_replace(st, rng_key=keys[r]), model, rcfg))
    return tree_map(lambda *xs: torch.stack(xs), *states)


def num_replicas(st: SimState) -> int:
    """Replica count of an ensemble state (st.now is [R] there)."""
    if st.now.ndim != 1:
        raise ValueError("not an ensemble state: expected now with shape [R]")
    return st.now.shape[0]


def replica_slice(st: SimState, r: int) -> SimState:
    """Replica r's single-world SimState (leaf views, no copy) of a
    stacked ensemble state."""
    return tree_map(lambda leaf: leaf[r], st)


def grow_ensemble_state(
    st: SimState,
    queue_capacity: "int | None" = None,
    outbox_capacity: "int | None" = None,
) -> SimState:
    """grow_state on every replica of a stacked [R, ...] state: the whole
    batch's fixed-slot buffers widen together, keeping one shape.
    Trajectory-neutral per replica for the same reason the single-world
    grow is (engine/state.py)."""
    return _grow(st, queue_capacity, outbox_capacity, axis=2)


def _aggregate_probe(rows: np.ndarray) -> ChunkProbe:
    """The [R, lanes] probe as one ChunkProbe for progress, heartbeat and
    checkpoint-cadence consumers: counters sum across replicas,
    next_time and now take the min (progress follows the slowest
    replica), the round counters and high-water marks the max."""
    out = {}
    for name, i in _LANE.items():
        col = rows[:, i]
        if name in _MIN_LANES:
            out[name] = int(col.min())
        elif name in _MAX_LANES:
            out[name] = int(col.max())
        else:
            out[name] = int(col.sum())
    return ChunkProbe(**out)


def _replica_capacity_error(rows: np.ndarray) -> Exception:
    """A CapacityError for the first replica whose overflow lane fired,
    carrying the replica index (err.replica) and naming it."""
    bad = np.nonzero(rows[:, _LANE["overflow"]] > 0)[0]
    r = int(bad[0])
    row = rows[r]
    err = _capacity_error(
        int(row[_LANE["overflow"]]),
        queue_ov=int(row[_LANE["queue_overflow"]]),
        outbox_ov=int(row[_LANE["outbox_overflow"]]),
        queue_hwm=int(row[_LANE["queue_hwm"]]),
        outbox_hwm=int(row[_LANE["outbox_hwm"]]),
    )
    err.replica = r
    detail = f"replica {r} of {rows.shape[0]}"
    if bad.size > 1:
        detail += f" (+{bad.size - 1} more replica(s) saturated)"
    err.args = (f"{err.args[0]} [{detail}]",)
    return err


def _patch_snapshot(host: "dict[str, np.ndarray]",
                    final_rows: "dict[int, np.ndarray]") -> "dict[str, np.ndarray]":
    """Rewrite a host (state_to_host) snapshot's `now` and round counters
    for every replica already recorded quiescent, to the values of its
    own quiescence chunk's probe line, the values _finish restores at the
    end of the run. A replica that quiesces early keeps taking idle
    rounds while slower replicas drain (touching exactly these leaves),
    so an unpatched mid-run checkpoint would bake those idle rounds in
    and a resumed run could never end leaf-exact to the uninterrupted
    one. Replicas not (yet) in final_rows are already at their true
    values and stay untouched."""
    if not final_rows:
        return host
    out = dict(host)
    for name, path in (("now", ".now"), ("rounds_live", ".tracker.rounds_live"),
                       ("rounds_idle", ".tracker.rounds_idle")):
        col = np.array(host[path], copy=True)
        for r, row in final_rows.items():
            col[r] = row[_LANE[name]]
        out[path] = col
    return out


def _finish(out: SimState, final_rows: "dict[int, np.ndarray]") -> SimState:
    """Restore each replica's `now` and round counters to the values its
    probe carried at its own quiescence chunk. A replica that quiesced
    early keeps taking idle rounds while slower replicas drain; those
    rounds touch only these leaves, so writing the recorded lines back
    makes every replica leaf-exact to its single run, which stops at
    that chunk."""
    r = num_replicas(out)

    def lane(name, like):
        vals = [int(final_rows[i][_LANE[name]]) for i in range(r)]
        return torch.tensor(vals, dtype=like.dtype, device=like.device)

    tr = out.tracker
    return _replace(
        out,
        now=lane("now", out.now),
        tracker=_replace(tr, rounds_live=lane("rounds_live", tr.rounds_live),
                         rounds_idle=lane("rounds_idle", tr.rounds_idle)),
    )


def run_ensemble_until(
    st: SimState,
    end_time: int,
    model,
    tables: RoutingTables,
    cfg: EngineConfig,
    rounds_per_chunk: int = 64,
    max_chunks: int = 10_000,
    on_chunk=None,
    counters=None,
    on_rows=None,
    on_state=None,
    tracker=None,
) -> SimState:
    """Host-side ensemble driver: chunks of `rounds_per_chunk` rounds over
    the whole batch until no replica has work left before end_time. `st`
    is an init_ensemble_state [R, ...] stack; the returned state has the
    same shape, and the caller's state is never modified. Rounds group
    into chunks exactly as in run_until; in each round a replica with no
    work takes the idle branch (its `now` moves and it counts an idle
    round) while the others drain. `on_chunk(probe: ChunkProbe)` sees
    each chunk's probe aggregated across replicas, `on_rows(rows)` the
    raw [R, lanes] numpy probe; `counters` (a dict) accumulates "iters",
    the batch's drain iterations. `on_state` taps
    chunk-boundary snapshots of the [R, ...] stack as run_until taps a
    world's (the reference's _drive_ensemble), each patched by
    _patch_snapshot. `tracker` records run_until's dispatch spans (no
    per-host heartbeats: a line per host cannot name its replica), and the
    installed flight recorder observes each chunk's aggregate probe
    before its overflow check."""
    cfg = ensemble_engine_cfg(cfg)
    validate_runahead(cfg, tables)
    n = num_replicas(st)
    nt = _LANE["next_time"]
    entry = state_probe(st).cpu().numpy()
    if int(entry[:, nt].min()) >= end_time:
        check_capacity(st)
        return st
    # replicas quiescent at entry keep the entry state's values
    final_rows = {r: entry[r] for r in range(n) if int(entry[r, nt]) >= end_time}
    with _tspan(tracker, "donate_copy"):
        st = rows_view(st.clone())
    flightrec.begin_segment()
    end_t = torch.tensor(end_time, dtype=torch.int64, device=st.device)

    def launch(st):
        for k in range(rounds_per_chunk):
            start = per_replica(st, equeue.next_time(st.queue)).amin(dim=1)
            has_traffic = per_replica(st, st.outbox.valid).any(dim=1)
            window_end = _next_window_end(st, end_time, cfg, start, tables)
            live = (start < end_t) | has_traffic
            if not bool(live.any()):
                # every replica quiescent: this and every later round of
                # the chunk take the idle branch with the same window end
                st = _replace(st, now=torch.maximum(st.now, window_end))
                if cfg.tracker:
                    st = _replace(st, tracker=_replace(
                        st.tracker, rounds_idle=st.tracker.rounds_idle + (rounds_per_chunk - k)))
                break
            width = window_end - torch.minimum(start, window_end)
            st = _replace(st, win_ns_sum=st.win_ns_sum + torch.where(live, width, 0))
            # an idle replica's `now` moves to its window end in run_round
            st = run_round(st, window_end, model, tables, cfg, counters, live=live)
            if cfg.tracker:
                st = _replace(st, tracker=_replace(
                    st.tracker,
                    rounds_live=st.tracker.rounds_live + live.to(torch.int64),
                    rounds_idle=st.tracker.rounds_idle + (~live).to(torch.int64),
                ))
        return st

    def snapshot(st):
        with _tspan(tracker, "state_snapshot", chunk=chunks):
            return _patch_snapshot(state_to_host(stacked_view(st)), final_rows)

    chunks = 0
    pending = False  # a due snapshot of this chunk's state (see run_until)
    while True:
        with _tspan(tracker, "chunk_launch" if chunks else "compile+launch", chunk=chunks):
            st = launch(st)
        chunks += 1
        with _tspan(tracker, "probe_fetch", chunk=chunks - 1):
            rows = state_probe(st).cpu().numpy()
        probe = _aggregate_probe(rows)
        flightrec.observe_probe(probe, chunk=chunks - 1)
        ahead = chunks < max_chunks
        if rows[:, _LANE["overflow"]].any():
            err = _replica_capacity_error(rows)
            attach_capacity_bytes(err, st)
            raise err
        if on_rows is not None:
            on_rows(rows)
        if on_chunk is not None:
            on_chunk(probe)
        for r in range(n):
            if r not in final_rows and int(rows[r, nt]) >= end_time:
                final_rows[r] = rows[r]
        if on_state is not None:
            pending = tap_chunk(on_state, probe, chunks - 1, st, launch, snapshot,
                                pending, ahead)
        if len(final_rows) == n:
            return _finish(stacked_view(st), final_rows)
        if chunks >= max_chunks:
            raise RuntimeError(
                f"simulation did not reach end_time={end_time} within "
                f"{max_chunks}x{rounds_per_chunk} rounds; raise max_chunks/rounds_per_chunk"
            )
