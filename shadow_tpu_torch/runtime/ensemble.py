"""EnsembleRunner: the runtime face of the ensemble plane (port of
shadow_tpu/runtime/ensemble.py).

Runs a scripted world with `general.replicas > 1` (`--replicas N`,
`--replica-seed-stride K`) as one batch of R seeded replicas, with the
same run() surface as TpuScheduler. ensemble_stats folds the final state
into sim-stats.json's `ensemble` section: one block per replica and
mean/stddev/min/max/95% CI across replicas.

run() carries the reference runner's checkpoint, interrupt, recovery
and tracker seams (a regrow widens the whole batch); flatten_host_stats
folds the batch's per-host tensors for the tracker. Not carried yet:
its compile-cache seam.
"""

from __future__ import annotations

import math

import numpy as np

from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.engine.ensemble import (
    ensemble_engine_cfg,
    grow_ensemble_state,
    init_ensemble_state,
    num_replicas,
    replica_seeds,
    run_ensemble_until,
)
from shadow_tpu_torch.engine.round import effective_engine, host_stats, model_pump_capable
from shadow_tpu_torch.engine.state import EngineConfig
from shadow_tpu_torch.graph.routing import RoutingTables


class EnsembleRunner:
    """R seeded replicas of one world on one device (`cuda` unless asked
    for `cpu`), run as one batch."""

    name = "tpu-ensemble"

    def __init__(self, model, tables: RoutingTables, cfg: EngineConfig, num_replicas: int,
                 *, seed_stride: int = 1, rounds_per_chunk: int = 256,
                 tx_bytes_per_interval=None, rx_bytes_per_interval=None, on_rows=None,
                 device="cuda"):
        if num_replicas < 1:
            raise ValueError("num_replicas must be >= 1")
        self.device = resolve_device(device)
        self.cfg = ensemble_engine_cfg(cfg)
        self.model = model
        self.tables = tables.to(self.device)
        self.num_replicas = num_replicas
        self.seed_stride = seed_stride
        self.rounds_per_chunk = rounds_per_chunk
        self.tx_bytes_per_interval = tx_bytes_per_interval
        self.rx_bytes_per_interval = rx_bytes_per_interval
        self.on_rows = on_rows
        # the engine run_round executes for this model here: the kernel
        # on the card for a model with a kernel instance
        self.engine = (
            effective_engine(cfg, self.device) if model_pump_capable(model) else "plain"
        )

    @property
    def seeds(self) -> "list[int]":
        return replica_seeds(self.cfg, self.num_replicas, self.seed_stride)

    def initial_state(self):
        """The bootstrapped [R, ...] t=0 stack: also the template a resume
        loads a checkpoint into (same config, same shapes)."""
        return init_ensemble_state(
            self.cfg, self.model, self.num_replicas, self.seed_stride,
            tx_bytes_per_interval=self.tx_bytes_per_interval,
            rx_bytes_per_interval=self.rx_bytes_per_interval,
            device=self.device,
        )

    def _runner_factory(self, end_time_ns: int, on_chunk, max_chunks, tracker=None):
        def factory(cfg):
            def run(st, on_state=None):
                return run_ensemble_until(
                    st, end_time_ns, self.model, self.tables, cfg,
                    rounds_per_chunk=self.rounds_per_chunk, max_chunks=max_chunks,
                    on_chunk=on_chunk, on_rows=self.on_rows, on_state=on_state,
                    tracker=tracker,
                )

            return run

        return factory

    def run(self, end_time_ns: int, on_chunk=None, max_chunks: int = 100_000,
            start_state=None, checkpoints=None, guard=None, recovery=None, tracker=None):
        """Run the whole batch to end_time_ns (the driver stops when the
        slowest replica quiesces). Mirrors TpuScheduler.run, with the
        regrow step on the whole [R, ...] batch (grow_ensemble_state)."""
        from shadow_tpu_torch.runtime.recovery import RecoveryPolicy, run_until_recovering

        st = start_state if start_state is not None else self.initial_state()
        self.recovery_report = []
        factory = self._runner_factory(end_time_ns, on_chunk, max_chunks, tracker)
        try:
            if recovery is None and checkpoints is None and guard is None:
                # the plain path: no taps, no recovery wrapper
                return factory(self.cfg)(st)
            final, self.recovery_report = run_until_recovering(
                st, end_time_ns, cfg=self.cfg,
                policy=recovery or RecoveryPolicy(max_recoveries=0),
                checkpoints=checkpoints, guard=guard, tracker=tracker,
                runner_factory=factory,
                grow_fn=grow_ensemble_state,
            )
        except Exception as err:
            self.recovery_report = list(getattr(err, "recoveries", []))
            raise
        return final


def _agg(values) -> dict:
    """mean/stddev/min/max and a normal-approximation 95% CI over one
    per-replica metric (sample stddev; CI half-width 1.96 * sd / sqrt(R),
    degenerate to the point value at R=1)."""
    a = np.asarray(values, dtype=np.float64)
    mean = float(a.mean())
    sd = float(a.std(ddof=1)) if a.size > 1 else 0.0
    half = 1.96 * sd / math.sqrt(a.size) if a.size > 1 else 0.0
    return {
        "mean": round(mean, 4),
        "stddev": round(sd, 4),
        "min": float(a.min()),
        "max": float(a.max()),
        "ci95": [round(mean - half, 4), round(mean + half, 4)],
    }


def ensemble_stats(
    final,
    seeds: "list[int]",
    wall_seconds: float,
    sim_seconds: float,
    seed_stride: int = 1,
    host_tensors: "dict | None" = None,
) -> dict:
    """The `ensemble` section of sim-stats.json: one block per replica
    (events/packets/drops/bytes/rounds summed over its hosts, from one
    bulk host_stats fetch) and the aggregate statistics across replicas
    of events, packets, bytes and events per wall second, with the
    amortization figures (wall per replica, sim-sec per wall-sec per
    replica)."""
    hs = host_tensors if host_tensors is not None else host_stats(final)
    r = num_replicas(final)
    if len(seeds) != r:
        raise ValueError(f"{len(seeds)} seeds for {r} replicas")
    wall_per_replica = wall_seconds / r if r else float("nan")
    per = []
    for i in range(r):
        per.append(
            {
                "replica": i,
                "seed": int(seeds[i]),
                "events_handled": int(np.sum(hs["events_handled"][i])),
                "packets_sent": int(np.sum(hs["packets_sent"][i])),
                "packets_dropped": int(np.sum(hs["packets_dropped"][i])),
                "packets_unroutable": int(np.sum(hs["packets_unroutable"][i])),
                "bytes_sent": int(np.sum(hs["bytes_sent"][i])),
                "bytes_ctrl": int(np.sum(hs["bytes_ctrl"][i])),
                "bytes_data": int(np.sum(hs["bytes_data"][i])),
                "rounds_live": int(hs["rounds_live"][i]),
                "rounds_idle": int(hs["rounds_idle"][i]),
            }
        )
    events = [p["events_handled"] for p in per]
    return {
        "replicas": r,
        "seed_stride": int(seed_stride),
        "wall_seconds": round(wall_seconds, 4),
        "wall_seconds_per_replica": round(wall_per_replica, 4),
        "sim_sec_per_wall_sec_per_replica": round(sim_seconds / wall_per_replica, 4)
        if wall_per_replica > 0
        else None,
        "per_replica": per,
        "aggregate": {
            "events_handled": _agg(events),
            "packets_sent": _agg([p["packets_sent"] for p in per]),
            "bytes_sent": _agg([p["bytes_sent"] for p in per]),
            "bytes_data": _agg([p["bytes_data"] for p in per]),
            "events_per_wall_second": _agg([e / wall_seconds for e in events])
            if wall_seconds > 0
            else None,
        },
    }


def flatten_host_stats(hs: dict) -> dict:
    """Collapse the [R, H] per-host tensors of an ensemble host_stats
    fetch into the flat shape the host-side tracker fold expects
    (utils/tracker.py sums/maxes over one axis): per-host arrays flatten
    to [R*H]; the per-replica round scalars reduce to their max (exact
    per-replica rounds live in the `ensemble` stats block instead). The
    window-width pair is the exception: mean_ns = win_ns_sum /
    rounds_live must take both from the same population, so the fold
    gets the across-replica totals (win_rounds_live carries the summed
    denominator)."""
    out = {}
    for k, v in hs.items():
        a = np.asarray(v)
        if k == "win_ns_sum":
            out[k] = int(a.sum())
        elif k in ("rounds_live", "rounds_idle"):
            out[k] = int(a.max())
        else:
            out[k] = a.reshape(-1)
    out["win_rounds_live"] = int(np.asarray(hs["rounds_live"]).sum())
    return out
