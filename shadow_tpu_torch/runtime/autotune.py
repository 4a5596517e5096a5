"""Compile-budget autotuner (port of shadow_tpu/runtime/autotune.py): pick
`rounds_per_chunk` (and a pump_k cap) before the run pays its first
chunk.

  * the reference's chunk compile cost is ~linear in the chunk length
    (rounds_per_chunk), so a tiny chunk (probe_rpc rounds) projects the
    full chunk's cost with one cheap measurement;
  * given a wall budget, the planner walks a candidate ladder
    (requested -> 128 -> 64 -> 32 -> 16) and picks the largest
    rounds_per_chunk whose projection (times the number of engine builds
    about to happen) fits;
  * probe walls persist in a small JSON cache keyed by the canonicalized
    static EngineConfig (engine/state.py trace_static_cfg, whose repr is
    the reference's), the backend ("cpu", or "gpu" on the card) and the
    dispatch shape, so repeat runs of a world skip the probe. A cache
    file written by either package on the CPU answers for the other.

The choice is trajectory-neutral: rounds_per_chunk only groups rounds
into chunks (quiescent tails take the idle branch), so two runs that
differ only in the autotuned value are leaf-identical, which is why the
knobs are excluded from the config fingerprint and an autotuned resume
stays exact.

`peak_hbm_bytes` is the CUDA allocator's peak over the probe on the card
(None on the CPU): best-effort, as the reference's figure from an AOT
executable is.

What the port's probe measures differs: the port compiles nothing per
chunk length (the kernel is built once), so the probe times the plain
engine's eager execution of probe_rpc rounds, and `projected_compile_s`
is a projected execution wall. On the card that projection is large and
a probed plan usually walks to the floor. The plans, the ladder and the
cache are kept the reference's for parity; `plan_pump_k` has no caller
in the port yet (the reference's is its benchmark).
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import time

import torch

DEFAULT_CANDIDATES = (128, 64, 32, 16)
# the smallest chunk the planner will ever choose; also the threshold
# below which probing is pointless
RPC_FLOOR = 16
PROBE_RPC = 4
PROBE_END_NS = 10_000_000


@dataclasses.dataclass(frozen=True)
class AutotunePlan:
    """One rounds_per_chunk decision, with the evidence it was made on.
    `source`: "probe" (fresh tiny-chunk measurement), "cache" (persisted
    probe wall reused), "floor" (requested already at/below the floor),
    or "disabled" (no budget given)."""

    rounds_per_chunk: int
    requested: int
    budget_s: float
    n_compiles: float
    probe_rpc: int
    probe_wall_s: "float | None"
    projected_compile_s: "float | None"
    pump_k: "int | None"  # None = keep the caller's value
    source: str
    backend: str = ""
    # the device allocator's peak over the probe: best-effort, None where
    # the device reports none or the probe was skipped
    peak_hbm_bytes: "int | None" = None

    def as_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}


def backend_name(device) -> str:
    """The backend half of the probe cache key: "gpu" on the card, "cpu"
    on the CPU (the reference's jax.default_backend() names)."""
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def _cache_key(cfg, probe_rpc: int, backend: str, shape_key: str = "") -> str:
    from shadow_tpu_torch.engine.state import trace_static_cfg

    blob = f"{trace_static_cfg(cfg)!r}|rpc={probe_rpc}|{backend}"
    if shape_key:
        # the dispatch shape (an ensemble's [R] batch) scales the cost
        # independently of the static cfg: a single world's probe wall
        # never answers for a batch
        blob += f"|{shape_key}"
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def _load_cache(path: "str | None") -> dict:
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_cache(path: "str | None", data: dict) -> None:
    if not path:
        return
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(data, f)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is an optimization, never a failure


def candidate_ladder(requested: int, floor: int = RPC_FLOOR) -> "list[int]":
    cands = [requested] + [c for c in DEFAULT_CANDIDATES if c < requested]
    if cands[-1] > floor:
        cands.append(floor)
    return cands


def plan_rounds_per_chunk(
    st0,
    model,
    tables,
    cfg,
    *,
    requested: int,
    budget_s: float,
    n_compiles: float = 1.0,
    probe_rpc: int = PROBE_RPC,
    probe_end_ns: int = PROBE_END_NS,
    floor: int = RPC_FLOOR,
    cache_path: "str | None" = None,
    tracker=None,
    probe_runner=None,
    shape_key: str = "",
    device="cuda",
) -> AutotunePlan:
    """Measure (or recall) the tiny-chunk wall and choose the largest
    rounds_per_chunk whose projected cost fits `budget_s`. `n_compiles`
    scales the projection by how many engine builds the caller is about
    to pay.

    The probe runs a real `run_until` of `probe_end_ns` sim-ns at
    `probe_rpc` rounds per chunk on the caller's initial state (copied by
    the chunk loop, never consumed), with the plain engine pinned, as
    the reference's does. `st0` may be a zero-arg callable building that
    state lazily: cache hits, the rpc floor and a zero budget return
    before the probe and never pay the state build.

    `probe_runner(st, end_ns, rpc, cfg, tracker)` overrides the probe's
    chunk loop so the probe runs the shape the run will (an ensemble
    passes run_ensemble_until); `shape_key` names that shape in the cache
    key. `device` names the backend of the cache key (backend_name)."""
    backend = backend_name(device)
    if budget_s <= 0:
        return AutotunePlan(
            rounds_per_chunk=requested, requested=requested, budget_s=budget_s,
            n_compiles=n_compiles, probe_rpc=probe_rpc, probe_wall_s=None,
            projected_compile_s=None, pump_k=None, source="disabled",
            backend=backend,
        )
    if requested <= floor:
        return AutotunePlan(
            rounds_per_chunk=requested, requested=requested, budget_s=budget_s,
            n_compiles=n_compiles, probe_rpc=probe_rpc, probe_wall_s=None,
            projected_compile_s=None, pump_k=None, source="floor",
            backend=backend,
        )

    key = _cache_key(cfg, probe_rpc, backend, shape_key)
    cache = _load_cache(cache_path)
    probe_wall = cache.get(key, {}).get("probe_wall_s")
    peak_hbm = cache.get(key, {}).get("peak_hbm_bytes")
    source = "cache" if probe_wall is not None else "probe"
    if probe_wall is None:
        from shadow_tpu_torch.engine.round import run_until
        from shadow_tpu_torch.runtime import flightrec

        probe_cfg = dataclasses.replace(cfg, engine="plain", pump_k=0)
        probe_st = st0() if callable(st0) else st0  # built outside the wall
        on_card = backend == "gpu"
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        # the probe's cost is real wall the run pays: a tracker span
        span = (
            tracker.span("autotune_probe", rpc=probe_rpc)
            if tracker is not None
            else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        with span, flightrec.suspended():
            # suspended: the probe drives a throwaway state through the
            # real chunk loop; its probes stay out of the run's metrics
            # (the decision event below is the probe's footprint there)
            if probe_runner is not None:
                probe_runner(probe_st, probe_end_ns, probe_rpc, probe_cfg, tracker)
            else:
                run_until(probe_st, probe_end_ns, model, tables, probe_cfg,
                          rounds_per_chunk=probe_rpc, tracker=tracker)
            if on_card:
                torch.cuda.synchronize(device)
        probe_wall = time.perf_counter() - t0
        if on_card:
            peak_hbm = int(torch.cuda.max_memory_allocated(device)) or None
        flightrec.record_event(
            "autotune_probe", wall_s=round(probe_wall, 4), rpc=probe_rpc,
            backend=backend, **({"shape": shape_key} if shape_key else {}),
            **({"peak_hbm_bytes": peak_hbm} if peak_hbm else {}),
        )
        cache[key] = {
            "probe_wall_s": round(probe_wall, 4),
            "probe_rpc": probe_rpc,
            "backend": backend,
            "saved_at": int(time.time()),
        }
        if peak_hbm:
            cache[key]["peak_hbm_bytes"] = peak_hbm
        _save_cache(cache_path, cache)

    chosen, projected = requested, None
    for cand in candidate_ladder(requested, floor):
        chosen = cand
        projected = probe_wall * (cand / probe_rpc) * n_compiles
        if projected <= budget_s:
            break
    return AutotunePlan(
        rounds_per_chunk=chosen, requested=requested, budget_s=budget_s,
        n_compiles=n_compiles, probe_rpc=probe_rpc,
        probe_wall_s=round(probe_wall, 4),
        projected_compile_s=round(projected, 4) if projected is not None else None,
        pump_k=None, source=source, backend=backend,
        peak_hbm_bytes=int(peak_hbm) if peak_hbm else None,
    )


def plan_pump_k(
    plan: AutotunePlan, cfg, *, candidates=(16, 8, 4), budget_share: float = 0.25
) -> AutotunePlan:
    """Cap pump_k under the same budget: the pump's cost grows ~linearly
    in pump_k the way the chunk grows in rounds_per_chunk. Project from
    the probe wall (the plain engine is ~one microstep per iteration) and
    pick the largest candidate whose extra cost fits `budget_share` of
    the budget. Returns the plan unchanged (`pump_k` None: keep) when the
    probe never ran or the caller pinned the plain engine."""
    if plan.probe_wall_s is None or cfg.engine == "plain":
        return plan
    per_k = plan.probe_wall_s * (plan.rounds_per_chunk / plan.probe_rpc)
    limit = plan.budget_s * budget_share
    chosen = candidates[-1]
    for cand in candidates:
        chosen = cand
        if per_k * cand <= limit:
            break
    current = cfg.pump_k if cfg.pump_k > 0 else 8
    if chosen >= current:
        return plan  # never raise pump_k above the caller's choice
    return dataclasses.replace(plan, pump_k=chosen)
