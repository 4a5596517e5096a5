"""Rollback-and-regrow capacity recovery (port of
shadow_tpu/runtime/recovery.py).

The engine's fixed-slot buffers (event queue, outbox, delivery grid)
fail loudly on overflow: the per-chunk probe carries the overflow split,
so a CapacityError surfaces at the chunk where the first event was
dropped (engine/round.py). Here it becomes a recoverable fault:

  1. roll back to the newest verified clean state — the retained host
     snapshot a StateRetainer committed at a chunk boundary whose probe
     passed the capacity check, or the caller's entry state when no
     snapshot exists yet;
  2. regrow the saturated buffer along an escalation ladder (x`growth`
     per recovery, targeting the counter the CapacityError names —
     queue vs outbox — with a bounded retry budget);
  3. replay from the rollback point at the new capacities (on the card
     a regrown buffer reaches the kernel as new runtime Q / O).

Replay is deterministic: growing a buffer is trajectory-neutral for a
state that never overflowed (engine/state.py grow_state), so the
recovered run is leaf-exact to a run that started with the larger
capacity. Recovery wraps the chunk loops (run_until, run_ensemble_until);
it does not live inside them. The reference's device-loss and watchdog
rungs belong to planes the port does not carry yet (multi-device, the
chunk watchdog).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from shadow_tpu_torch.engine.round import CapacityError, run_until
from shadow_tpu_torch.engine.state import (
    fmt_bytes,
    grow_state,
    price_regrow,
    snapshot_nbytes,
    state_from_host,
    state_to_host,
)
from shadow_tpu_torch.runtime import flightrec, memtrack
from shadow_tpu_torch.runtime.checkpoint import StateTap
from shadow_tpu_torch.utils.shadow_log import slog


@dataclasses.dataclass
class RecoveryPolicy:
    """The escalation ladder's budget. max_recoveries=0 restores fail-fast
    (`--no-recover`)."""

    max_recoveries: int = 4
    growth: int = 2
    snapshot_interval_chunks: int = 32


class StateRetainer:
    """Keeps the newest verified host snapshot as the rollback point.
    Snapshots arrive through StateTap.commit, i.e. only after a probe
    verified them, so a retained state never contains a silent drop.
    Held on the host, it stays valid while the device state moves on."""

    def __init__(self, every_chunks: int):
        self.every = max(1, int(every_chunks))
        self.host_state = None
        self._last_chunk = 0

    def due(self, chunk_idx: int) -> bool:
        return chunk_idx - self._last_chunk >= self.every

    def commit(self, host_state) -> None:
        self.host_state = host_state
        self._last_chunk += self.every

    def seed(self, host_state) -> None:
        """Install a rollback point directly (the regrown replay start)."""
        self.host_state = host_state
        self._last_chunk = 0


def grown_cfg(cfg, err: CapacityError, growth: int):
    """The next rung of the escalation ladder: multiply by `growth` the
    capacity of the buffer the CapacityError names. Queue growth also
    widens an explicit deliver_lanes grid (the round-boundary delivery
    grid is a queue-side resource: its overflow counts into
    queue.overflow). When the error carries no split, grow both."""
    q_ov = getattr(err, "queue_overflow", 0)
    o_ov = getattr(err, "outbox_overflow", 0)
    if not q_ov and not o_ov:
        q_ov = o_ov = 1
    changes = {}
    if q_ov:
        changes["queue_capacity"] = cfg.queue_capacity * growth
        if cfg.deliver_lanes > 0:
            changes["deliver_lanes"] = cfg.deliver_lanes * growth
    if o_ov:
        changes["outbox_capacity"] = cfg.outbox_capacity * growth
        if cfg.a2a_capacity > 0:
            changes["a2a_capacity"] = cfg.a2a_capacity * growth
        if cfg.pool_capacity > 0:
            changes["pool_capacity"] = cfg.pool_capacity * growth
    return dataclasses.replace(cfg, **changes)


def run_until_recovering(
    st,
    end_time: int,
    model=None,
    tables=None,
    cfg=None,
    *,
    rounds_per_chunk: int = 64,
    max_chunks: int = 10_000,
    on_chunk=None,
    tracker=None,
    policy: "RecoveryPolicy | None" = None,
    checkpoints=None,
    guard=None,
    runner_factory=None,
    grow_fn=None,
):
    """run_until with the recovery loop wrapped around it. Returns
    (final_state, recoveries), recoveries being the list of recovery
    records ([] for a clean run). `runner_factory(cfg) -> run(st,
    on_state=...) -> SimState` overrides the chunk loop (the ensemble
    runner passes a run_ensemble_until one); the default is run_until.
    `checkpoints`/`guard` ride the same StateTap (one shared snapshot per
    due point). `grow_fn` overrides the regrow step (default grow_state; the ensemble runner
    passes grow_ensemble_state, so the whole [R, ...] batch widens
    together). Each recovery is a record for `tracker` (utils/tracker.py)
    and an event and a survivable black box for the installed flight
    recorder (runtime/flightrec.py); a terminal error writes the black
    box with what the run survived."""
    policy = policy or RecoveryPolicy()
    grow = grow_fn or grow_state

    if runner_factory is None:

        def runner_factory(run_cfg):
            def run(run_st, on_state=None):
                return run_until(
                    run_st, end_time, model, tables, run_cfg,
                    rounds_per_chunk=rounds_per_chunk, max_chunks=max_chunks,
                    on_chunk=on_chunk, on_state=on_state, tracker=tracker,
                )

            return run

    # The retainer is armed lazily, after the first CapacityError: a run
    # without a fault pays no periodic snapshot and holds no host copy;
    # its rollback point is the caller's entry state, which the chunk loops
    # never modify. Replays do retain snapshots, so repeated rungs never
    # replay the whole run again.
    retainer = None
    cur_st, cur_cfg = st, cfg
    recoveries: "list[dict]" = []
    while True:
        tap = None
        if retainer is not None or checkpoints is not None or guard is not None:
            tap = StateTap(checkpoints=checkpoints, retainer=retainer, guard=guard)
        if checkpoints is not None:
            # checkpoints written during this attempt record its (possibly
            # regrown) config knobs for resume
            checkpoints.engine_cfg = cur_cfg
        try:
            final = runner_factory(cur_cfg)(cur_st, on_state=tap)
            return final, recoveries
        except CapacityError as err:
            if len(recoveries) >= policy.max_recoveries:
                # terminal: what the run survived before it died rides the
                # exception, and the black box is written (its last sample
                # is the failing chunk's probe: the chunk loops record it
                # before raising)
                err.recoveries = list(recoveries)
                flightrec.post_mortem(err, recoveries=len(recoveries))
                raise
            if retainer is not None and retainer.host_state is not None:
                base_host = retainer.host_state
                try:
                    base = state_from_host(base_host, cur_st)
                except Exception as mat_err:  # noqa: BLE001
                    # the snapshot cannot be put back on the device (out of
                    # memory, or the device failed): a structured terminal
                    # error with its black box, never a raw crash of this
                    # handler
                    err.recoveries = list(recoveries)
                    err.args = (
                        f"{err.args[0]} — and the retained snapshot cannot be "
                        f"materialized ({type(mat_err).__name__}); resume from "
                        "the checkpoint directory",
                    )
                    flightrec.post_mortem(err, recoveries=len(recoveries))
                    raise err from mat_err
                from_ns = int(np.min(np.asarray(base_host[".now"])))
            else:
                base = cur_st  # the caller's entry state
                # ensemble states carry a [R] `now`: the rollback point is
                # the slowest replica's window (the batch replays together)
                try:
                    from_ns = int(base.now.min())
                except Exception as fetch_err:  # noqa: BLE001
                    # the entry state is unreadable (the device failed): no
                    # replay is possible
                    err.recoveries = list(recoveries)
                    err.args = (
                        f"{err.args[0]} — and the rollback state is unreadable "
                        f"({type(fetch_err).__name__}); recovery needs a "
                        "retained snapshot or --checkpoint-dir",
                    )
                    flightrec.post_mortem(err, recoveries=len(recoveries))
                    raise err from fetch_err
            new_cfg = grown_cfg(cur_cfg, err, policy.growth)
            # price the regrown state before allocating it: the one moment
            # the regrow can still warn that it will not fit the device.
            # Best-effort: pricing never blocks the recovery itself.
            headroom: dict = {}
            mem_note = ""
            try:
                headroom["bytes_current"] = snapshot_nbytes(base)
                headroom["bytes_regrown"] = price_regrow(
                    base,
                    queue_capacity=new_cfg.queue_capacity,
                    outbox_capacity=new_cfg.outbox_capacity,
                )
                mem_note = (
                    f"; state {fmt_bytes(headroom['bytes_current'])}"
                    f" -> {fmt_bytes(headroom['bytes_regrown'])}"
                )
                limit = (memtrack.device_memory(base.now.device) or {}).get("bytes_limit")
                if limit and headroom["bytes_regrown"] > limit:
                    headroom["would_exceed_hbm"] = True
                    mem_note += f" WOULD EXCEED the {fmt_bytes(limit)} device limit"
            except Exception:  # noqa: BLE001 — pricing is telemetry
                headroom, mem_note = {}, ""
            grown = grow(
                base,
                queue_capacity=new_cfg.queue_capacity,
                outbox_capacity=new_cfg.outbox_capacity,
            )
            record = {
                "kind": "capacity",
                "queue_overflow": getattr(err, "queue_overflow", 0),
                "outbox_overflow": getattr(err, "outbox_overflow", 0),
                "queue_capacity": new_cfg.queue_capacity,
                "outbox_capacity": new_cfg.outbox_capacity,
                "replay_from_ns": from_ns,
                **headroom,
            }
            if getattr(err, "replica", None) is not None:
                # ensemble runs: name the replica that saturated, although
                # the whole batch rolls back and regrows together
                record["replica"] = err.replica
            recoveries.append(record)
            slog(
                "warning",
                from_ns,
                "recovery",
                f"capacity exhausted (queue_ov={record['queue_overflow']}, "
                f"outbox_ov={record['outbox_overflow']}); rolling back to "
                f"sim time {from_ns} ns and regrowing to "
                f"queue_capacity={new_cfg.queue_capacity}, "
                f"outbox_capacity={new_cfg.outbox_capacity}{mem_note} "
                f"(recovery {len(recoveries)}/{policy.max_recoveries})",
            )
            if tracker is not None:
                tracker.record_recovery(record)
            # the recovery is an event in the metrics stream and a
            # survivable black box (overwritten by a later, terminal dump
            # if the run dies after all)
            flightrec.record_event("recovery", **record)
            flightrec.post_mortem(
                failure={"kind": f"recovery:{record['kind']}", "recovered": True, **record},
            )
            cur_st, cur_cfg = grown, new_cfg
            if retainer is None:
                retainer = StateRetainer(policy.snapshot_interval_chunks)
            # the replay may overflow again before reaching a fresh
            # snapshot: seed the rollback point with the regrown start so
            # the next rung never replays stale shapes (or the whole run)
            retainer.seed(state_to_host(grown))
