"""Chaos plane (port of shadow_tpu/runtime/chaos.py): deterministic fault
injection and the degradation ladder it exercises.

A `FaultPlan` is built from `--chaos-seed` / the `chaos:` config section
and holds a list of `FaultSpec`s (fault kind, trigger site, optional
target, budget). Trigger sites left as ``at: auto`` are drawn from the
plan's own PRNG stream, seeded by ``(chaos.seed, kind, ordinal)``, so
the same seed and config always give the same injection schedule: a
chaos run replays exactly, which lets the tests hold it leaf-identical
to the fault-free run. The runtime's seams consult the installed plan
through `fire()`; with no plan installed every hook is one module-global
``is None`` check.

The seams the port carries:

  ``capacity``      raise a CapacityError at chunk `at` after its probe
                    (engine/round.py run_until, engine/ensemble.py
                    run_ensemble_until): rollback-and-regrow.
  ``stall``         sleep `stall_s` seconds inside the probe fetch of
                    chunk `at`, the region the chunk watchdog
                    (`experimental.chunk_watchdog_s`) measures.
  ``compile``       fail the first chunk of the engine named by `target`
                    (or of whichever engine runs first): the engine
                    fallback ladder (megakernel -> pump -> plain).
  ``ckpt-corrupt``  overwrite bytes inside checkpoint file number `at`
                    after it is written (runtime/checkpoint.py): the
                    sha-256 check and `latest_path`'s fall-back-to-valid.
  ``ckpt-truncate`` truncate checkpoint file number `at`.

The plan parses every kind of the reference's catalog
(config/options.py FAULT_KINDS); the manager refuses, with NotYetPorted,
a plan that names a kind whose seam is not ported (LATER_KINDS).

The one deliberate difference from the reference: its compile seam
wraps any exception raised by chunk 0's launch into EngineCompileError,
and the ladder then falls a rung. In the port chunk 0's launch is where
nvcc builds the kernel, so that wrap would quietly run the twin in the
kernel's place. Here only an injected `compile` fault falls a rung; a
kernel that fails to build or launch stops the run with its own error.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import random

from shadow_tpu_torch.config.options import FAULT_KINDS
from shadow_tpu_torch.utils.shadow_log import slog

# default range for `at: auto` trigger draws (chunk/window ordinals):
# early chunks, where every run path is still live
AUTO_AT_MAX = 4

# caps for persistent (count: -1) faults, which fire once per chunk: the
# fired record list in sim-stats and the warning log stay O(1) in run
# length
MAX_FIRED_RECORDS = 100
MAX_FIRED_LOGS = 5

# fault kinds whose seams belong to planes the port does not carry yet
# (the services, the multi-device mesh)
LATER_KINDS = (
    "preempt",
    "daemon-kill",
    "spool-corrupt",
    "cache-corrupt",
    "http-drop",
    "lease-steal",
    "device-loss",
)


@dataclasses.dataclass
class FaultSpec:
    """One injectable fault. `at` is the site ordinal the fault fires at
    (chunk index, checkpoint number): an int pins it, "auto" draws it
    from the plan's PRNG stream, None fires at the first opportunity.
    `target` restricts firing to sites tagged with that string (an engine
    name); None matches any site. `count` bounds total firings (-1 =
    persistent: fires every time it matches)."""

    kind: str
    at: "int | str | None" = None
    target: "str | None" = None
    count: int = 1
    stall_s: float = 1.0  # kind="stall" only: injected dispatch delay

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown chaos fault kind {self.kind!r} "
                f"(expected one of {sorted(FAULT_KINDS)})"
            )
        if self.kind == "compile" and self.at is not None:
            # the compile seam fires at the first matching chunk 0 (there
            # is no chunk ordinal yet): a sited compile fault would never
            # fire
            raise ValueError(
                "compile faults fire at the first matching compile and "
                "take no @AT site; use target=<engine> to pick the engine"
            )
        if self.at is not None and self.at != "auto":
            self.at = int(self.at)
            if self.at < 0:
                raise ValueError(
                    "chaos fault at must be >= 0 (a site ordinal) or 'auto'"
                )
        self.count = int(self.count)
        if self.count == 0 or self.count < -1:
            raise ValueError("chaos fault count must be >= 1 or -1 (persistent)")
        self.stall_s = float(self.stall_s)
        if self.stall_s < 0:
            raise ValueError("chaos fault stall_s must be >= 0 seconds")


class FaultPlan:
    """A deterministic injection schedule: two plans built from the same
    (seed, faults) fire at identical sites in identical order (`at: auto`
    draws come from ``random.Random((seed, kind, ordinal))``, never from
    the wall clock or global RNG state); `reset()` restores the budgets
    for a replay."""

    def __init__(self, seed: int = 0, faults=(), at_max: int = AUTO_AT_MAX):
        self.seed = int(seed)
        self.at_max = int(at_max)
        self.faults: "list[FaultSpec]" = []
        for i, f in enumerate(faults):
            spec = f if isinstance(f, FaultSpec) else FaultSpec(**dict(f))
            if spec.at == "auto":
                draw = random.Random(f"{self.seed}:{spec.kind}:{i}")
                spec = dataclasses.replace(spec, at=draw.randrange(self.at_max))
            self.faults.append(spec)
        self._budget = [s.count for s in self.faults]
        self._fires = [0 for _ in self.faults]
        self.fired: "list[dict]" = []

    def reset(self) -> None:
        """Restore every fault's budget (replay the same schedule)."""
        self._budget = [s.count for s in self.faults]
        self._fires = [0 for _ in self.faults]
        self.fired = []

    def should_fire(self, kind: str, at=None, tags=()) -> "FaultSpec | None":
        for i, spec in enumerate(self.faults):
            if spec.kind != kind or self._budget[i] == 0:
                continue
            if spec.target is not None and spec.target not in tags:
                continue
            if spec.at is not None and at != spec.at:
                continue
            if self._budget[i] > 0:
                self._budget[i] -= 1
            self._fires[i] += 1
            if len(self.fired) < MAX_FIRED_RECORDS:
                rec = {"kind": kind, "at": at}
                if spec.target is not None:
                    rec["target"] = spec.target
                self.fired.append(rec)
            if self._fires[i] <= MAX_FIRED_LOGS:
                slog("warning", 0, "chaos",
                     f"injecting fault: {kind} at site {at}"
                     + (f" (target {spec.target})" if spec.target else "")
                     + (" — further firings of this fault logged silently"
                        if self._fires[i] == MAX_FIRED_LOGS else ""))
            return spec
        return None

    def report(self) -> dict:
        """The `chaos` section of sim-stats.json: what actually fired.
        `fired` holds the first MAX_FIRED_RECORDS records; `fired_total`
        is the true count when more fired."""
        rep = {
            "seed": self.seed,
            "planned": len(self.faults),
            "fired": list(self.fired),
        }
        total = sum(self._fires)
        if total > len(self.fired):
            rep["fired_total"] = total
        return rep


# --- installation -------------------------------------------------------
# One plan per process, installed around a run by the manager (or a
# test's `installed()` context). Ambient tags (scoped_tags) let a seam
# that does not know its logical identity still be targeted by name.

_PLAN: "FaultPlan | None" = None
_TAGS: tuple = ()


def install(plan: "FaultPlan | None") -> None:
    global _PLAN
    _PLAN = plan


def uninstall() -> None:
    install(None)


def active() -> "FaultPlan | None":
    return _PLAN


@contextlib.contextmanager
def installed(plan: "FaultPlan | None"):
    prev = _PLAN
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


@contextlib.contextmanager
def scoped_tags(*tags: str):
    """Add ambient site tags for the duration of the block; fault
    targets match against them."""
    global _TAGS
    prev = _TAGS
    _TAGS = prev + tuple(tags)
    try:
        yield
    finally:
        _TAGS = prev


def fire(kind: str, at=None, tags=()) -> "FaultSpec | None":
    """The one hook every seam calls: the matching FaultSpec (consuming
    one unit of its budget) or None. No plan installed = one global
    read."""
    if _PLAN is None:
        return None
    return _PLAN.should_fire(kind, at=at, tags=tuple(tags) + _TAGS)


def plan_from_config(chaos_cfg) -> "FaultPlan | None":
    """FaultPlan from a ChaosOptions section, or None when it declares no
    faults (the zero-chaos path)."""
    if chaos_cfg is None or not chaos_cfg.faults:
        return None
    return FaultPlan(seed=chaos_cfg.seed, faults=chaos_cfg.faults)


def parse_fault_arg(arg: str) -> dict:
    """Parse one --chaos-fault flag value into a fault dict:
    ``KIND[@AT][:key=val...]``, e.g. ``capacity@2``,
    ``stall@1:stall_s=0.5``, ``capacity:target=ph-s3:count=-1``. AT is an
    int or ``auto``."""
    head, *opts = arg.split(":")
    kind, _, at_s = head.partition("@")
    fault: dict = {"kind": kind.strip()}
    if at_s:
        fault["at"] = at_s if at_s == "auto" else int(at_s)
    for opt in opts:
        key, sep, val = opt.partition("=")
        if not sep:
            raise ValueError(f"--chaos-fault option {opt!r} is not key=val")
        key = key.strip()
        if key == "count":
            fault["count"] = int(val)
        elif key == "stall_s":
            fault["stall_s"] = float(val)
        elif key == "target":
            fault["target"] = val
        elif key == "at":
            fault["at"] = val if val == "auto" else int(val)
        else:
            raise ValueError(f"unknown --chaos-fault option {key!r}")
    FaultSpec(**fault)  # validate loudly at parse time
    return fault


def injected_capacity_error(at, spec: "FaultSpec | None" = None):
    """The CapacityError a `capacity` fault raises: structurally a real
    overflow of the queue (recovery regrows it), tagged `injected` so
    reports tell simulated faults from real saturation."""
    from shadow_tpu_torch.engine.round import CapacityError

    detail = f", target {spec.target}" if spec is not None and spec.target else ""
    err = CapacityError(
        f"injected fault: event capacity exhausted at chunk {at} "
        f"(chaos plane{detail})"
    )
    err.queue_overflow = 1
    err.injected = True
    return err


@contextlib.contextmanager
def compile_seam(engine: str):
    """The seam around a chunk loop's first launch, where the engine's
    chunk program is first built (on the card: the kernel's nvcc build).
    An injected `compile` fault targeting `engine` raises a typed
    EngineCompileError, which the fallback ladder acts on. Any other
    exception passes through as itself: a kernel that fails to build or
    launch stops the run, and no rung runs the twin in its place."""
    from shadow_tpu_torch.engine.round import EngineCompileError

    if fire("compile", tags=(engine,)) is not None:
        cause = RuntimeError(f"injected fault: {engine} engine compile failed (chaos plane)")
        raise EngineCompileError(engine, cause) from cause
    yield


def damage_file(path: str, truncate: bool) -> None:
    """The `ckpt-corrupt` / `ckpt-truncate` payload: truncate the file to
    half its size, or overwrite a span in the middle with a marker
    pattern. Applied after the atomic write completes: bit-rot or partial
    storage loss on a committed checkpoint, which the sha-256 digest and
    `latest_path`'s fall-back-to-valid defend against."""
    size = os.path.getsize(path)
    if truncate:
        os.truncate(path, max(size // 2, 1))
        return
    with open(path, "r+b") as f:
        f.seek(max(size // 2 - 16, 0))
        f.write(b"\xde\xad\xbe\xef" * 8)


# --- engine fallback ladder --------------------------------------------
# megakernel -> pump -> plain. Sound as a degradation ladder because the
# three engines are leaf-exact on every model: falling a rung changes
# wall-clock, never a result leaf.


def next_engine_cfg(cfg, device):
    """The next rung down from cfg's effective engine on `device`, or None
    at the bottom. "auto" resolves to what it runs there (the megakernel
    on the card; pump when pump_k > 0, else plain, on the CPU)."""
    from shadow_tpu_torch.engine.round import effective_engine

    effective = effective_engine(cfg, device)
    if effective == "megakernel":
        return dataclasses.replace(
            cfg, engine="pump", pump_k=cfg.pump_k if cfg.pump_k > 0 else 8
        )
    if effective == "pump":
        return dataclasses.replace(cfg, engine="plain")
    return None


def run_with_engine_ladder(cfg, attempt, on_fallback=None, device="cuda"):
    """Run `attempt(cfg)`, downgrading the engine one rung per
    EngineCompileError until plain fails too (then the error propagates:
    a structured, named failure). Returns (attempt result, fallback
    records). Each record lands in sim-stats.json's `degraded` section,
    so a degraded run is visibly degraded, never silently slower."""
    from shadow_tpu_torch.engine.round import EngineCompileError
    from shadow_tpu_torch.runtime import flightrec

    fallbacks: "list[dict]" = []
    while True:
        try:
            return attempt(cfg), fallbacks
        except EngineCompileError as err:
            nxt = next_engine_cfg(cfg, device)
            if nxt is None:
                raise
            rec = {
                "from": err.engine or cfg.engine,
                "to": nxt.engine,
                "reason": str(err.__cause__ or err)[:300],
            }
            fallbacks.append(rec)
            slog(
                "warning", 0, "engine",
                f"{rec['from']} engine failed to compile "
                f"({rec['reason']}); falling back to {rec['to']} "
                "(bit-identical results, possibly slower)",
            )
            # a fallback is a survivable degradation: an event in the
            # metrics stream and a black box of the moment the ladder acted
            flightrec.record_event("engine_fallback", **rec)
            flightrec.post_mortem(
                failure={"kind": "engine_fallback", "recovered": True, **rec}
            )
            if on_fallback is not None:
                on_fallback(rec)
            cfg = nxt
