"""Sweep scheduler service: a multi-tenant job queue over the ensemble
and checkpoint planes (port of shadow_tpu/runtime/sweep.py, copied with
its imports rewritten and its engine seams bound to the port's
EnsembleRunner, Manager, checkpoint, flightrec and chaos modules).

The reference's flagship methodology (Jansen et al., "Once is Never
Enough", USENIX Security 2021) needs MANY repeated experiments per
conclusion, and five planes of this repo already exist to serve that —
bit-exact checkpoints, capacity recovery, the batched ensemble runner,
the sync-free tracker probe. This module is the layer that composes
them into one serving system:

  * **Expansion** (config/sweep.py): a declarative spec expands into
    per-seed SweepJobs, each a fully validated single-world config.
  * **Packing** (`pack_jobs`, pure): jobs with the same config
    fingerprint **modulo seed** are the same compiled world; runs of
    seeds in arithmetic progression fold into ONE ensemble batch
    (replica r ≡ seed base + r*stride, the exactness contract of
    engine/ensemble.py), capped at the spec's capacity.
  * **Compile cache** (runtime/compile_cache.py): a batch's chunk is
    prepared once per (fingerprint-modulo-seed, rounds_per_chunk, state
    signature) and reused: N same-shape jobs pay one build (on the card,
    the pump kernel's library and its launch check), including a
    preempted batch's resume.
  * **Priority + preemption**: batches run highest-priority-first on a
    deterministic virtual clock (cumulative sim-time executed, advanced
    from the per-chunk probe — zero extra device syncs). When a
    higher-priority batch arrives mid-run, the running batch writes a
    verified final checkpoint through the existing CheckpointManager/
    StateTap machinery and re-queues; its later resume is bit-exact
    (the same machinery tests/test_robustness.py pins).
  * **Reporting**: every job gets a standalone-equivalent
    `sim-stats.json` (replica slice ≡ single run, so the file matches a
    `shadow-tpu run` of that seed modulo wall-clock), and the sweep
    writes `sweep-manifest.json` — per-job status/progress/recoveries,
    per-batch packing and preemption records, compile-cache counters,
    and cross-job aggregate tables.

Batches run on one device, `cuda` unless the service is asked for the
CPU (`device="cpu"`, `sweep --device cpu`); on the card a batch of a
model with a kernel instance launches the pump kernel over its R * H
rows every drain iteration, and a kernel that fails to build or launch
fails the batch (the split/retry/quarantine ladder), never runs the
plain twin. With `sweep.mesh: RxS` every batch runs through the
mesh plane (runtime/mesh.py MeshRunner) on a grid of logical devices, its
rows degraded for ragged or split batches (MeshPlan.for_batch); a batch
that loses a device finishes on a smaller grid, recorded in the
manifest (`mesh_effective`, `mesh_degradations`).
Each job's sim-stats.json gains the port's `execution` section (device,
engine, the batch and its kernel launches).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time

import numpy as np

from shadow_tpu_torch.config.options import ConfigOptions
from shadow_tpu_torch.config.sweep import SweepJob, SweepSpec
from shadow_tpu_torch.engine.round import (
    PROBE_FIELDS,
    CapacityError,
    EngineCompileError,
    RunInterrupted,
    WatchdogExpired,
    host_stats,
)
from shadow_tpu_torch.runtime.compile_cache import CompileCache
from shadow_tpu_torch.runtime.manager import Manager, SimResults
from shadow_tpu_torch.simtime import NS_PER_SEC, fmt_time_ns
from shadow_tpu_torch.utils.shadow_log import slog

PROBE_NOW = PROBE_FIELDS.index("now")
PROBE_EVENTS = PROBE_FIELDS.index("events_handled")


@dataclasses.dataclass
class Batch:
    """One packed unit of device work: an ordered run of jobs whose
    seeds form an arithmetic progression, executed as one [R]-replica
    ensemble program (job i is replica i, seeded base_seed + i*stride)."""

    jobs: "list[SweepJob]"
    base_seed: int
    stride: int
    priority: int
    arrival_ns: int
    group_key: str
    index: int = -1
    # daemon-mode fields (runtime/daemon.py): the owning tenant (fair-
    # share accounting + tenant gauges) and a restart-stable checkpoint
    # directory key — identical pending jobs re-pack into a batch with
    # the same dir_key after a crash, so its checkpoints are findable
    tenant: "str | None" = None
    dir_key: "str | None" = None
    # mutable execution record
    preemptions: int = 0
    resume_ckpt: "str | None" = None
    status: str = "pending"
    wall_seconds: float = 0.0
    recoveries: int = 0
    error: "str | None" = None
    failure: "str | None" = None  # structured kind: capacity/watchdog/...
    engine_fallbacks: "list[dict]" = dataclasses.field(default_factory=list)
    # the elastic-mesh record: the grid the batch finished on (a device
    # loss may have shrunk it mid-run) and the reshapes the runner made
    mesh_effective: "str | None" = None
    mesh_degradations: "list[dict]" = dataclasses.field(default_factory=list)
    # pump kernel launches while the batch ran (the port's `execution`)
    kernel_launches: int = 0

    @property
    def replicas(self) -> int:
        return len(self.jobs)

    def describe(self) -> dict:
        return {
            "index": self.index,
            "group": self.group_key[:12],
            "jobs": [j.name for j in self.jobs],
            "replicas": self.replicas,
            "base_seed": self.base_seed,
            "seed_stride": self.stride,
            "priority": self.priority,
            "arrival_ns": self.arrival_ns,
            **({"tenant": self.tenant} if self.tenant else {}),
        }


def pack_jobs(jobs: "list[SweepJob]", capacity: int = 8,
              mesh_rows: int = 1) -> "list[Batch]":
    """The packing decision, as a pure function of the job list (unit-
    testable without devices — tests/test_sweep_pack.py).

    Jobs group by (fingerprint-modulo-seed, priority, arrival): only
    identical worlds batch, and a batch must be schedulable as one unit.
    Within a group, seeds sort ascending and fold into maximal
    arithmetic-progression runs — the ensemble plane's seeding contract
    is replica r = base + r*stride (rng.replica_keys), so only an AP of
    seeds can ride one [R] program — capped at `capacity` replicas.
    Deterministic: equal inputs always produce the same batch list, in
    priority-then-arrival order.

    `mesh_rows` is the mesh-slice capacity a 2-D sweep teaches the
    packer (SweepSpec.mesh, docs/parallelism.md "2-D mesh"): batch
    sizes are cut at the largest multiple of the mesh's replica rows
    that fits `capacity`, so full batches fill whole mesh rows and the
    device grid never idles a row on an avoidably ragged batch. A
    group's remainder (or capacity < rows) still packs — the runner
    degrades that batch's rows (MeshPlan.for_batch)."""
    if capacity < 1:
        raise ValueError("capacity must be >= 1")
    if mesh_rows > 1 and capacity > mesh_rows:
        capacity -= capacity % mesh_rows
    groups: "dict[tuple, list[SweepJob]]" = {}
    for j in jobs:
        groups.setdefault((j.group_key, j.priority, j.arrival_ns), []).append(j)
    batches: "list[Batch]" = []
    for (gk, prio, arr) in sorted(groups, key=lambda k: (-k[1], k[2], k[0])):
        js = sorted(groups[(gk, prio, arr)], key=lambda j: j.seed)
        i = 0
        while i < len(js):
            run = [js[i]]
            stride = 1
            if i + 1 < len(js):
                stride = js[i + 1].seed - js[i].seed
                # stride 0 = the same seed twice (two spec entries over
                # one world): replica streams must be distinct, so those
                # jobs run as separate batches
                if stride > 0:
                    k = i + 1
                    while (
                        k < len(js)
                        and len(run) < capacity
                        and js[k].seed == run[-1].seed + stride
                    ):
                        run.append(js[k])
                        k += 1
            if len(run) == 1:
                stride = 1
            batches.append(
                Batch(
                    jobs=run,
                    base_seed=run[0].seed,
                    stride=stride,
                    priority=prio,
                    arrival_ns=arr,
                    group_key=gk,
                )
            )
            i += len(run)
    for i, b in enumerate(batches):
        b.index = i
    return batches


class _PreemptGuard:
    """The scheduler-owned twin of runtime/checkpoint.py InterruptGuard:
    same `fired()` surface StateTap consults, armed by the service when
    a higher-priority batch becomes runnable instead of by a signal. The
    driver then takes the identical code path — verified final
    checkpoint, RunInterrupted — that makes resume bit-exact."""

    def __init__(self):
        self._armed = False

    def arm(self) -> None:
        self._armed = True

    def fired(self, now_ns: int) -> bool:
        return self._armed


class _Preempted(Exception):
    pass


def _failure_kind(err: BaseException) -> str:
    from shadow_tpu_torch.engine.round import DeviceLossError
    from shadow_tpu_torch.runtime.checkpoint import CheckpointError

    if isinstance(err, CapacityError):
        return "capacity"
    if isinstance(err, WatchdogExpired):
        return "watchdog"
    if isinstance(err, EngineCompileError):
        return "compile"
    if isinstance(err, CheckpointError):
        return "checkpoint"
    if isinstance(err, DeviceLossError):
        return "device-loss"
    return type(err).__name__


def retry_backoff_s(base_s: float, job_name: str, attempt: int) -> float:
    """The wall backoff before retry number `attempt` of a split single
    job: exponential (base * 2^(attempt-1)) with seeded, BOUNDED jitter —
    a multiplicative factor in [0.5, 1.5) drawn chaos-style from
    ``random.Random(f"backoff:{job_name}:{attempt}")``
    (runtime/chaos.py's site-draw idiom), so N jobs split out of one
    failed batch fan their retries out instead of stampeding the compile
    cache in lockstep, while any replay of the same sweep sleeps the
    exact same schedule. Pure and wall-clock-free so the unit test pins
    it without sleeping (tests/test_elastic.py)."""
    import random

    base = base_s * (2 ** (attempt - 1))
    if base <= 0:
        return 0.0
    jitter = random.Random(f"backoff:{job_name}:{attempt}").random()
    return base * (0.5 + jitter)


class SweepService:
    """Executes a SweepSpec: packs, queues, runs, preempts, reports.
    One instance per sweep; the compile cache lives for its lifetime.
    Batches run on `device` (`cuda` unless asked for `cpu`)."""

    def __init__(self, spec: SweepSpec, metrics_file: "str | None" = None,
                 metrics_prom: "str | None" = None, cache=None, device="cuda"):
        from shadow_tpu_torch.device import resolve_device

        self.spec = spec
        # 2-D mesh batches (SweepSpec.mesh): (replica rows, host shards)
        # of the grid every batch dispatches on, or None for the
        # single-device ensemble plane
        self.mesh = None
        if getattr(spec, "mesh", None):
            from shadow_tpu_torch.config.options import parse_mesh

            self.mesh = parse_mesh(spec.mesh)
        self.device = resolve_device(device)
        # injectable cache: the daemon passes a PersistentCompileCache
        # so prepared chunks survive restarts (runtime/compile_cache.py)
        self.cache = cache if cache is not None else CompileCache()
        self.batches = pack_jobs(spec.jobs, spec.capacity,
                                 mesh_rows=self.mesh[0] if self.mesh else 1)
        self.clock_ns = 0  # virtual clock: cumulative sim-time executed
        self.job_progress: "dict[str, dict]" = {
            j.name: {"now_ns": 0, "events": 0} for j in spec.jobs
        }
        self.job_records: "dict[str, dict]" = {}
        # Service-level telemetry (runtime/flightrec.py; docs/service.md):
        # the recorder streams the drivers' per-chunk samples plus
        # batch/queue events, `job_series` keeps a bounded per-job time
        # series keyed off the per-replica probe rows (zero extra device
        # syncs — the rows already arrive via on_rows), and
        # `queue_depth_series` gauges the queue at every scheduling
        # decision. `metrics_prom` makes the service scrapeable.
        self.metrics_file = metrics_file
        self.metrics_prom = metrics_prom
        self.recorder = None  # built in run()
        self.job_series: "dict[str, list[dict]]" = {
            j.name: [] for j in spec.jobs
        }
        self.queue_depth_series: "list[dict]" = []
        # per-job failed attempts (the retry/quarantine ladder's budget
        # counter; docs/service.md "Retries and quarantine")
        self.job_attempts: "dict[str, int]" = {}
        # Validate every distinct world up front (construction = world
        # validation, one representative job per fingerprint group), so a
        # bad scenario fails as a one-line config error BEFORE any batch
        # has burned a compile — and keep the built Manager: per-job
        # output writing reuses it instead of re-expanding the world N
        # times (the hosts/graph/IP expansion is seed-independent).
        self._group_mgr: "dict[str, Manager]" = {}
        self.validate_jobs(spec.jobs)

    def validate_jobs(self, jobs: "list[SweepJob]") -> None:
        """World-validate every distinct fingerprint group among `jobs`
        (one Manager build per group), caching the Managers for the
        per-job output writes. Raises ValueError on the first bad world
        — BEFORE any of its jobs is queued or any compile is burned.
        Also the daemon's admission validator (runtime/daemon.py): a
        refused spool spec becomes a structured rejection record."""
        for j in jobs:
            if j.group_key in self._group_mgr:
                continue
            mgr = Manager(j.config, device=self.device)
            if mgr.managed_mode:
                raise ValueError(
                    f"sweep.jobs.{j.entry}: sweeps run scripted-model "
                    "scenarios only (the jobs batch onto the device "
                    "engine); managed executables run via `shadow-tpu run`"
                )
            if j.config.experimental.scheduler != "tpu":
                raise ValueError(
                    f"sweep.jobs.{j.entry}: sweeps require "
                    "experimental.scheduler: tpu (jobs batch through the "
                    "vmapped ensemble plane)"
                )
            if self.mesh is not None and len(mgr.hosts) % self.mesh[1]:
                raise ValueError(
                    f"sweep.jobs.{j.entry}: {len(mgr.hosts)} hosts must "
                    f"divide evenly over the sweep mesh's {self.mesh[1]} "
                    f"host-shard(s) ({self.spec.mesh})"
                )
            self._group_mgr[j.group_key] = mgr

    def enqueue(self, jobs: "list[SweepJob]", tenant: "str | None" = None,
                dir_key: "str | None" = None) -> "list[Batch]":
        """Live admission (the daemon's arrival path): pack `jobs` —
        already validated via validate_jobs — into fresh batches
        appended to self.batches, and return them for the caller to add
        to its pending queue. Jobs from one admission pack only with
        each other (a tenant's spool file is its own packing universe —
        cross-tenant worlds never share a device program)."""
        self.spec.jobs.extend(jobs)
        for j in jobs:
            self.job_progress.setdefault(j.name, {"now_ns": 0, "events": 0})
            self.job_series.setdefault(j.name, [])
        batches = pack_jobs(jobs, self.spec.capacity,
                            mesh_rows=self.mesh[0] if self.mesh else 1)
        for b in batches:
            b.index = len(self.batches)
            b.tenant = tenant
            if dir_key is not None:
                b.dir_key = (
                    f"{dir_key}-g{b.group_key[:8]}-p{b.priority}"
                    f"-s{b.base_seed}x{b.replicas}k{b.stride}"
                )
            self.batches.append(b)
        return batches

    # --- planning --------------------------------------------------------

    def plan(self) -> dict:
        """The packing decision without running anything (--show-plan)."""
        return {
            "sweep": self.spec.name,
            "jobs": len(self.spec.jobs),
            "capacity": self.spec.capacity,
            **({"mesh": self.spec.mesh} if self.mesh else {}),
            "batches": [b.describe() for b in self.batches],
        }

    # --- execution -------------------------------------------------------

    def run(self) -> dict:
        """Drain the queue: highest priority first among arrived batches,
        preempting a lower-priority run when a higher one arrives. A
        failed batch walks the degradation ladder (split → per-job retry
        with exponential backoff → quarantine) instead of voiding the
        sweep — one poison job must never take down the other N−1.
        Returns (and writes) the sweep manifest.

        When the base scenario carries a `chaos:` section, its FaultPlan
        is installed once for the whole sweep (chaos is excluded from
        the packing fingerprint, so it is sweep-global by construction);
        fault `target`s match job names via the ambient tags each batch
        scopes."""
        import contextlib

        from shadow_tpu_torch.runtime import chaos

        plan = (
            chaos.plan_from_config(self.spec.jobs[0].config.chaos)
            if self.spec.jobs else None
        )
        ctx = (
            chaos.installed(plan) if plan is not None
            else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        slog("info", 0, "sweep",
             f"{len(self.spec.jobs)} job(s) in {len(self.batches)} batch(es), "
             f"device={self.device}")
        os.makedirs(self.spec.output_dir, exist_ok=True)
        from shadow_tpu_torch.runtime.flightrec import FlightRecorder

        self.recorder = FlightRecorder(
            blackbox_path=os.path.join(
                self.spec.output_dir, "flight-recorder.json"
            ),
            metrics_path=self.metrics_file,
            prom_path=self.metrics_prom,
        )
        try:
            with ctx:
                self._drain(list(self.batches))
        finally:
            # close() first: its plain write_prom would otherwise clobber
            # the final service-gauge snapshot
            self.recorder.close()
            self._write_prom([])
        manifest = self._manifest(time.perf_counter() - t0)
        if plan is not None:
            manifest["chaos"] = plan.report()
        path = os.path.join(self.spec.output_dir, "sweep-manifest.json")
        with open(path, "w") as f:
            json.dump(manifest, f, indent=2)
        return manifest

    # --- scheduling seams (overridden by runtime/daemon.py) --------------

    def _poll(self, pending: "list[Batch]") -> None:
        """Admission hook, called before every scheduling decision. The
        one-shot sweep has a pre-declared queue; the daemon scans its
        spool directory here and appends newly admitted batches."""

    def _idle(self, pending: "list[Batch]") -> bool:
        """The queue is empty: return True to keep waiting for arrivals
        (the daemon sleeps a poll interval), False to finish draining."""
        return False

    def _stopping(self) -> bool:
        """Checked between batches: True ends the drain loop early (the
        daemon's graceful SIGTERM shutdown)."""
        return False

    def _select(self, ready: "list[Batch]") -> Batch:
        """The scheduling decision among arrived batches. One-shot
        sweeps run strict priority (ties: arrival, then plan order);
        the daemon adds weighted tenant fair-share within a priority."""
        return min(ready, key=lambda b: (-b.priority, b.arrival_ns, b.index))

    def _runnable(self, batch: Batch) -> bool:
        """May this arrived batch be scheduled right now? One-shot
        sweeps run everything; the daemon filters batches whose tenant
        is over its quota-class budget (parked until the window refills)
        or whose claim file a fleet peer holds unexpired."""
        return True

    def _claim(self, batch: Batch) -> bool:
        """Take exclusive ownership of `batch` before dispatch. One-shot
        sweeps own their whole queue; a fleet daemon commits a lease
        file here — False means a peer won the race and the batch goes
        back to pending (its claim now filters it via _runnable)."""
        return True

    def _should_park(self, batch: Batch) -> bool:
        """Checked at every chunk tick of the running batch: True parks
        it — verified checkpoint at the next boundary, re-queue, not
        lost — via the same guard path preemption uses (daemon: the
        tenant's quota-class budget ran out, or its lease was lost)."""
        return False

    def _on_progress(self, name: str, point: dict) -> None:
        """A job's per-chunk probe row landed in job_progress (daemon:
        fan out to HTTP event-stream subscribers)."""

    def _on_batch_start(self, batch: Batch, depth: int) -> None:
        """A batch was dispatched (daemon: journal record + kill seam)."""

    def _on_chunk_tick(self, batch: Batch, pending: "list[Batch]") -> None:
        """Every fetched chunk probe of the running batch (daemon:
        wall-cadence spool poll + prom rewrite + kill seam)."""

    def _account(self, batch: Batch, delta_ns: int) -> None:
        """`delta_ns` of sim time just executed for `batch` (daemon:
        weighted per-tenant fair-share accounting)."""

    def _on_job_terminal(self, name: str, record: dict) -> None:
        """A job reached a terminal status — done/failed/quarantined —
        and its record landed in job_records (daemon: journal it)."""

    def _ckpt_interval_ns(self, cfgo: ConfigOptions) -> int:
        """Periodic checkpoint cadence for a running batch. One-shot
        sweeps write only preemption-final checkpoints (0); the daemon
        uses the config's cadence so a SIGKILL mid-batch loses at most
        one interval of work."""
        return 0

    def _drain(self, pending: "list[Batch]") -> None:
        while True:
            self._poll(pending)
            if not pending:
                if not self._idle(pending):
                    break
                continue
            ready = [b for b in pending if b.arrival_ns <= self.clock_ns]
            if not ready:
                # idle queue: fast-forward the virtual clock to the next
                # arrival (nothing is executing, so no sim time passes)
                self.clock_ns = min(b.arrival_ns for b in pending)
                continue
            runnable = [b for b in ready if self._runnable(b)]
            if not runnable:
                # every arrived batch is blocked (daemon: parked tenant
                # budgets, a fleet peer's unexpired leases) — wait like
                # an empty queue instead of spinning on the filter
                if not self._idle(pending):
                    break
                continue
            batch = self._select(runnable)
            pending.remove(batch)
            if not self._claim(batch):
                # a fleet peer won the claim race: back to pending — the
                # fresh foreign lease now filters it via _runnable
                pending.append(batch)
                continue
            # queue-depth gauge at every scheduling decision (the running
            # batch counts toward the depth); getattr because the
            # retry-ladder unit tests drive a bare service shell
            depth = len(pending) + 1
            qseries = getattr(self, "queue_depth_series", None)
            if qseries is not None:
                qseries.append({"clock_ns": self.clock_ns, "depth": depth})
            rec = getattr(self, "recorder", None)
            if rec is not None:
                rec.event(
                    "batch_start", batch=batch.index, queue_depth=depth,
                    jobs=[j.name for j in batch.jobs],
                    priority=batch.priority,
                )
            self._on_batch_start(batch, depth)
            try:
                self._run_batch(batch, pending)
            except _Preempted:
                batch.preemptions += 1
                batch.status = "preempted"
                slog(
                    "info", self.clock_ns, "sweep",
                    f"batch {batch.index} preempted "
                    f"(checkpoint: {batch.resume_ckpt or 'none — restarts'})",
                )
                if rec is not None:
                    rec.event(
                        "preempt", batch=batch.index,
                        checkpoint=batch.resume_ckpt,
                    )
                pending.append(batch)
            except Exception as e:
                # EVERY batch error — typed ladder failures (capacity /
                # watchdog / compile / checkpoint) and untyped runtime
                # errors alike — walks the split/retry/quarantine ladder:
                # one poison job must never void the other N−1 or leave
                # the sweep without a manifest (_failure_kind falls back
                # to the exception's class name for the manifest record).
                # KeyboardInterrupt/SystemExit are BaseException and
                # still abort the sweep.
                self._handle_failure(batch, e, pending)
            self._write_prom(pending)
            if self._stopping():
                break

    def _requeue_job(self, job: SweepJob, like: Batch) -> Batch:
        """A fresh single-job batch for a retry/split: same scheduling
        class as the failed batch, restarted from scratch (a failure
        voids any preemption checkpoint the attempt left behind)."""
        nb = Batch(
            jobs=[job],
            base_seed=job.seed,
            stride=1,
            priority=like.priority,
            arrival_ns=like.arrival_ns,
            group_key=like.group_key,
            index=len(self.batches),
            tenant=like.tenant,
            # a retry's checkpoint dir must never alias another batch's
            # (daemon restarts resume by dir — a stale foreign
            # checkpoint would be rejected by fingerprint, but the
            # retry also starts from scratch by contract)
            dir_key=(
                f"{like.dir_key}-r{len(self.batches)}" if like.dir_key else None
            ),
        )
        self.batches.append(nb)
        return nb

    def _handle_failure(self, batch: Batch, err: BaseException,
                        pending: "list[Batch]") -> None:
        """The split → retry-with-backoff → quarantine ladder. A multi-
        job batch failure says nothing about WHICH job poisoned it:
        split it and retry the jobs individually (an injected or real
        fault that rode one job now fails only that job's batch). A
        single-job failure burns one unit of the job's retry_max budget;
        past the budget the job's terminal status lands in the manifest
        with its failure kind and the rest of the sweep proceeds:
        `quarantined` for a repeat offender (it failed again after a
        retry), plain `failed` when retry_max is 0 and the first failure
        was terminal."""
        from shadow_tpu_torch.runtime import flightrec

        kind = _failure_kind(err)
        batch.error = str(err)
        batch.failure = kind
        rec = getattr(self, "recorder", None)
        if rec is not None:
            rec.event(
                "batch_failure", batch=batch.index, failure=kind,
                jobs=[j.name for j in batch.jobs], error=str(err)[:200],
            )
        if batch.replicas > 1:
            batch.status = "split"
            slog(
                "warning", self.clock_ns, "sweep",
                f"batch {batch.index} failed ({kind}); splitting its "
                f"{batch.replicas} jobs into individual retries",
            )
            for job in batch.jobs:
                pending.append(self._requeue_job(job, batch))
            return
        job = batch.jobs[0]
        attempts = self.job_attempts.get(job.name, 0) + 1
        self.job_attempts[job.name] = attempts
        batch.status = "failed"
        if attempts <= self.spec.retry_max:
            backoff = retry_backoff_s(
                self.spec.retry_backoff_s, job.name, attempts
            )
            slog(
                "warning", self.clock_ns, "sweep",
                f"job {job.name} failed ({kind}); retrying "
                f"(attempt {attempts}/{self.spec.retry_max}"
                + (f", backoff {backoff:.3g}s" if backoff else "") + ")",
            )
            if backoff > 0:
                time.sleep(backoff)
            pending.append(self._requeue_job(job, batch))
            return
        status = "quarantined" if attempts > 1 else "failed"
        self.job_records[job.name] = self._job_record(
            job, batch, status=status, error=str(err), failure=kind,
        )
        self._on_job_terminal(job.name, self.job_records[job.name])
        if rec is not None:
            # the quarantined/failed job's post-mortem black box: one
            # dump in ITS data directory (the forensics travel with the
            # job's outputs) and one service-level dump — both carry the
            # failing chunk's sample, recorded by the driver before the
            # raise (docs/observability.md)
            failure = flightrec.failure_record(
                err, job=job.name, status=status, attempts=attempts,
                batch=batch.index,
            )
            job_dir = job.config.general.data_directory
            if job_dir:
                rec.dump(
                    failure=failure,
                    path=os.path.join(job_dir, "flight-recorder.json"),
                )
            rec.dump(failure=failure)
        slog(
            "warning", self.clock_ns, "sweep",
            f"job {job.name} {status} after {attempts} failed "
            f"attempt(s) (last failure: {kind}) — the rest of the sweep "
            "continues",
        )

    def _batch_grid(self, batch: Batch) -> "str | None":
        """The grid this batch dispatches on (the service mesh with its
        rows degraded for a ragged or split batch, MeshPlan.for_batch),
        or None on the single-device ensemble plane: one definition for
        the batch config, the runner's plan, the checkpoint layout and
        the daemon's journal records."""
        if self.mesh is None:
            return None
        from shadow_tpu_torch.engine.mesh import MeshPlan

        plan = MeshPlan.for_batch(batch.replicas, self.mesh[0], self.mesh[1])
        return f"{plan.rows}x{plan.shards}"

    def _batch_config(self, batch: Batch) -> ConfigOptions:
        """The ensemble config a batch runs under: the first job's
        resolved raw config with the replica axis folded in. Sound
        because every job in the batch shares the fingerprint modulo
        seed — the configs are identical except for the seed."""
        raw = copy.deepcopy(batch.jobs[0].raw_config)
        g = raw.setdefault("general", {})
        g["seed"] = batch.base_seed
        g["replicas"] = batch.replicas
        g["replica_seed_stride"] = batch.stride
        g["data_directory"] = self._batch_dir(batch)
        grid = self._batch_grid(batch)
        if grid is not None:
            # execution geometry only: the fingerprint hashes the replica
            # count, not the grid, so a checkpoint written here resumes
            # on any grid a restarted service ends up with
            g["mesh"] = grid
        return ConfigOptions.from_dict(raw)

    def _batch_dir(self, batch: Batch) -> str:
        # dir_key (daemon mode) is restart-stable: the same pending jobs
        # re-pack into the same key after a crash, so the replayed batch
        # finds its own checkpoints; index naming is the one-shot default
        return os.path.join(
            self.spec.output_dir, "batches",
            batch.dir_key or f"b{batch.index:03d}",
        )

    def _run_batch(self, batch: Batch, pending: "list[Batch]") -> None:
        from shadow_tpu_torch.config.fingerprint import (
            config_fingerprint,
            fingerprint_dict,
        )
        from shadow_tpu_torch.runtime.checkpoint import (
            CheckpointManager,
            load_checkpoint,
            peek_checkpoint_meta,
        )
        from shadow_tpu_torch.engine.megakernel import PUMP_KERNEL
        from shadow_tpu_torch.runtime.ensemble import EnsembleRunner
        from shadow_tpu_torch.runtime.recovery import RecoveryPolicy

        cfgo = self._batch_config(batch)
        mgr = Manager(cfgo, device=self.device)  # construction = world validation
        world = mgr.build_world()
        end = cfgo.general.stop_time_ns
        fingerprint = config_fingerprint(cfgo)

        # a preempted run may have regrown its buffers: resume at the
        # checkpoint's recorded widths (Manager._setup_checkpointing does
        # the same for --resume)
        ecfg = world.ecfg
        if batch.resume_ckpt is not None:
            meta = peek_checkpoint_meta(batch.resume_ckpt)
            overrides = {}
            qc, oc = meta.get("queue_capacity"), meta.get("outbox_capacity")
            if qc and oc:
                overrides.update(queue_capacity=qc, outbox_capacity=oc)
            for knob in ("deliver_lanes", "a2a_capacity", "pool_capacity"):
                if knob in meta:
                    overrides[knob] = meta[knob]
            if any(overrides.get(k) != getattr(ecfg, k) for k in overrides):
                ecfg = dataclasses.replace(ecfg, **overrides)

        rows_map = {j.name: r for r, j in enumerate(batch.jobs)}

        def on_rows(rows):
            # raw [R, PROBE_LANES] probe: one row per job, already
            # fetched by the driver — per-job progress costs zero syncs
            for name, r in rows_map.items():
                point = {
                    "now_ns": int(rows[r, PROBE_NOW]),
                    "events": int(rows[r, PROBE_EVENTS]),
                }
                self.job_progress[name] = point
                # bounded per-job time series for the manifest telemetry
                # (keyed off the same already-fetched probe rows)
                series = self.job_series.setdefault(name, [])
                series.append({"clock_ns": self.clock_ns, **point})
                del series[:-64]
                self._on_progress(name, point)

        common = dict(
            seed_stride=batch.stride,
            rounds_per_chunk=cfgo.experimental.rounds_per_chunk,
            tx_bytes_per_interval=world.tx_refill,
            rx_bytes_per_interval=world.rx_refill,
            compile_cache=self.cache,
            cache_key=batch.group_key,
            on_rows=on_rows,
            watchdog_s=cfgo.experimental.chunk_watchdog_s,
            device=self.device,
        )
        if self.mesh is not None:
            # a mesh batch: the same [R] job batch on a grid of logical
            # devices; the compile cache keys its chunk under the grid's
            # shape (MeshRunner._launch_for), so same-shape batches share
            # one build
            from shadow_tpu_torch.runtime.mesh import MeshRunner

            runner = MeshRunner(world.model, world.tables, ecfg, mgr.mesh_plan, **common)
        else:
            runner = EnsembleRunner(world.model, world.tables, ecfg,
                                    num_replicas=batch.replicas, **common)

        start_state = None
        start_now = 0
        grid = self._batch_grid(batch)
        if batch.resume_ckpt is not None:
            from shadow_tpu_torch.runtime.checkpoint import reshard_note

            # resume_ckpt came from latest_path, which verified the
            # sha-256 digest moments ago — skip the second full hash. The
            # snapshot is layout-free: one written on another grid (before
            # a crash or a degradation) reshards onto this batch's grid
            start_state, meta = load_checkpoint(
                batch.resume_ckpt, runner.initial_state(), fingerprint,
                check_digest=False, detail=fingerprint_dict(cfgo), layout=grid,
            )
            start_now = int(meta["now_ns"])
            slog("info", start_now, "sweep",
                 f"batch {batch.index} resuming from {batch.resume_ckpt}"
                 f"{reshard_note(meta.get('mesh'), grid)}")

        ckpt_dir = os.path.join(self._batch_dir(batch), "ckpts")
        # one-shot sweeps: interval 0, no periodic cadence — the only
        # writes are the verified final checkpoint a preemption commits.
        # Daemon mode uses the config's cadence (crash-loss bound).
        ckpt = CheckpointManager(
            ckpt_dir, self._ckpt_interval_ns(cfgo), fingerprint,
            layout=grid, detail=fingerprint_dict(cfgo),
        )
        guard = _PreemptGuard()
        recovery = None
        if cfgo.experimental.recover:
            recovery = RecoveryPolicy(
                max_recoveries=cfgo.experimental.recovery_max_retries,
                snapshot_interval_chunks=cfgo.experimental.recovery_snapshot_chunks,
            )

        last_now = [start_now]
        hb_ns = cfgo.general.heartbeat_interval_ns
        last_hb = [0]
        chunk_idx = [0]

        def on_chunk(probe):
            from shadow_tpu_torch.runtime import chaos

            # the aggregated probe's `now` follows the slowest replica;
            # its delta is the sim time this batch just executed
            delta = max(0, probe.now - last_now[0])
            self.clock_ns += delta
            last_now[0] = probe.now
            self._account(batch, delta)
            self._on_chunk_tick(batch, pending)
            if self._stopping():
                # graceful shutdown (daemon SIGTERM): checkpoint at the
                # next boundary and requeue — restart resumes bit-exact
                guard.arm()
            if self._should_park(batch):
                # quota-class exhaustion or lease loss mid-run (daemon):
                # same checkpoint-and-requeue path — parked, never lost
                guard.arm()
            if any(
                b.arrival_ns <= self.clock_ns and b.priority > batch.priority
                for b in pending
            ):
                guard.arm()
            # chaos `preempt` fault: arm the guard with no higher-priority
            # arrival at all — a storm of these exercises repeated
            # checkpoint/requeue/resume cycles (each resume is bit-exact,
            # so the storm cannot change any job's published stats)
            if chaos.fire("preempt", at=chunk_idx[0]) is not None:
                guard.arm()
            chunk_idx[0] += 1
            if hb_ns > 0 and self.clock_ns - last_hb[0] >= hb_ns:
                last_hb[0] = self.clock_ns
                slog(
                    "info", probe.now, "sweep",
                    f"batch {batch.index} [{batch.jobs[0].entry}] "
                    f"{batch.replicas} job(s): sim time {fmt_time_ns(probe.now)}, "
                    f"{probe.events_handled} events "
                    f"(service clock {fmt_time_ns(self.clock_ns)})",
                )

        slog(
            "info", self.clock_ns, "sweep",
            f"batch {batch.index} starting: jobs "
            f"{[j.name for j in batch.jobs]} (R={batch.replicas}, "
            f"base seed {batch.base_seed}, stride {batch.stride}, "
            f"priority {batch.priority})",
        )
        from shadow_tpu_torch.runtime import chaos

        from shadow_tpu_torch.runtime import flightrec

        launches0 = PUMP_KERNEL.launches
        t0 = time.perf_counter()
        try:
            # ambient tags = this batch's job names, so a chaos fault
            # with `target: <job>` fires only in batches carrying it —
            # the poison-job selector (docs/robustness.md). The service
            # recorder is installed for the batch's duration so the
            # driver's per-chunk samples and the compile cache's
            # hit/miss events stream into the service telemetry.
            with chaos.scoped_tags(*[j.name for j in batch.jobs]), \
                    flightrec.installed(self.recorder):
                final = runner.run(
                    end,
                    on_chunk=on_chunk,
                    start_state=start_state,
                    checkpoints=ckpt,
                    guard=guard,
                    recovery=recovery,
                )
            if self.device.type == "cuda":
                import torch

                torch.cuda.synchronize(self.device)
        except RunInterrupted:
            batch.wall_seconds += time.perf_counter() - t0
            batch.kernel_launches += PUMP_KERNEL.launches - launches0
            # latest_path integrity-checks candidates newest-first and
            # falls back to an older valid checkpoint, so one damaged
            # final write (chaos ckpt-corrupt, real bit-rot) costs a
            # partial replay, not the job. The extra read+hash of the
            # just-written file is the accepted price of that contract.
            batch.resume_ckpt = CheckpointManager.latest_path(ckpt_dir)
            raise _Preempted()
        except Exception:
            # the split/retry/quarantine ladder lives in _drain — this
            # frame keeps the wall accounting honest and preserves what
            # the batch survived before dying (a quarantined poison job
            # that went through 4 regrows must show recoveries: 4, not 0)
            batch.wall_seconds += time.perf_counter() - t0
            batch.kernel_launches += PUMP_KERNEL.launches - launches0
            batch.recoveries = len(getattr(runner, "recovery_report", []))
            batch.engine_fallbacks = list(
                getattr(runner, "engine_fallbacks", [])
            )
            batch.mesh_degradations = list(getattr(runner, "mesh_degradations", []))
            if self.mesh is not None:
                # a degraded-then-failed batch still names the grid it
                # died on
                batch.mesh_effective = f"{runner.plan.rows}x{runner.plan.shards}"
            raise
        batch.wall_seconds += time.perf_counter() - t0
        batch.kernel_launches += PUMP_KERNEL.launches - launches0
        batch.status = "done"
        batch.recoveries = len(runner.recovery_report)
        batch.engine_fallbacks = list(getattr(runner, "engine_fallbacks", []))
        if self.mesh is not None:
            # the grid the batch finished on: a device loss mid-batch
            # degrades the runner's plan instead of quarantining the jobs
            batch.mesh_effective = f"{runner.plan.rows}x{runner.plan.shards}"
            batch.mesh_degradations = list(getattr(runner, "mesh_degradations", []))
        self._write_batch_outputs(batch, final, end, runner)

    # --- per-job outputs -------------------------------------------------

    def _write_batch_outputs(self, batch, final, end, runner) -> None:
        from shadow_tpu_torch.engine.ensemble import replica_slice

        hs = host_stats(final)  # ONE bulk fetch for the whole batch
        wall_per_job = batch.wall_seconds / batch.replicas
        fallbacks = runner.engine_fallbacks
        # how the batch was executed (the port's sim-stats section, like
        # a standalone run's): the device, the ladder's last rung, and
        # the pump kernel's launches over the whole batch
        execution = {
            "package": "shadow_tpu_torch",
            "device": str(self.device),
            "engine": fallbacks[-1]["to"] if fallbacks else runner.engine,
            "batch": batch.index,
            "kernel_launches": {"pump_megakernel": batch.kernel_launches},
        }
        for r, job in enumerate(batch.jobs):
            sl_hs = {k: np.asarray(v)[r] for k, v in hs.items()}
            self._write_job(
                job, replica_slice(final, r), sl_hs, end, wall_per_job,
                runner.recovery_report, execution,
            )
            self.job_records[job.name] = self._job_record(
                job, batch, status="done",
                stats={
                    "events_handled": int(sl_hs["events_handled"].sum()),
                    "packets_sent": int(sl_hs["packets_sent"].sum()),
                    "packets_dropped": int(sl_hs["packets_dropped"].sum()),
                    "packets_unroutable": int(
                        sl_hs["packets_unroutable"].sum()
                    ),
                    "bytes_sent": int(sl_hs["bytes_sent"].sum()),
                },
                wall_seconds=round(wall_per_job, 4),
            )
            # terminal hook AFTER the job's outputs are on disk: a crash
            # between the write and the journal record re-runs the job
            # (idempotent — the rerun rewrites identical outputs), never
            # loses it
            self._on_job_terminal(job.name, self.job_records[job.name])

    def _write_job(self, job, final_slice, sl_hs, end, wall, recovery_report,
                   execution):
        """Publish one job's data dir exactly as a standalone
        `shadow-tpu run` of that seed would: sim-stats.json (the replica
        slice is leaf-identical to the standalone final state, so every
        counter matches; wall-clock fields necessarily differ),
        processed-config.json, and the hosts file. The group's validated
        Manager is reused with the job's config swapped in — host
        expansion and IP assignment are seed-independent, so the world
        is never re-built per job."""
        jmgr = self._group_mgr[job.group_key]
        jmgr.config = job.config
        results = SimResults(
            hosts=jmgr.hosts,
            events_handled=int(sl_hs["events_handled"].sum()),
            packets_sent=int(sl_hs["packets_sent"].sum()),
            packets_dropped=int(sl_hs["packets_dropped"].sum()),
            packets_unroutable=int(sl_hs["packets_unroutable"].sum()),
            wall_seconds=wall,
            sim_seconds=end / NS_PER_SEC,
            scheduler="tpu",
        )
        if recovery_report:
            results.extra_stats["recovery"] = {
                "count": len(recovery_report),
                "events": list(recovery_report),
            }
        if job.config.general.tracker:
            from shadow_tpu_torch.utils.tracker import Tracker

            tracker = Tracker(counters=True, host_heartbeats=False)
            jmgr._fold_tracker(
                tracker, results, end, final_state=final_slice,
                host_tensors=sl_hs,
            )
        results.extra_stats["execution"] = execution
        jmgr._write_outputs(results)

    def _job_record(self, job, batch, status, stats=None, error=None,
                    wall_seconds=None, failure=None) -> dict:
        rec = {
            "name": job.name,
            "entry": job.entry,
            "seed": job.seed,
            **({"tenant": batch.tenant} if batch.tenant else {}),
            "priority": job.priority,
            "arrival_ns": job.arrival_ns,
            "group": job.group_key[:12],
            "batch": batch.index,
            "status": status,
            "data_directory": job.config.general.data_directory,
            "preemptions": batch.preemptions,
            "recoveries": batch.recoveries,
            "progress": dict(self.job_progress[job.name]),
        }
        if job.name in self.job_attempts:
            rec["failed_attempts"] = self.job_attempts[job.name]
        if wall_seconds is not None:
            rec["wall_seconds"] = wall_seconds
        if stats:
            rec["stats"] = stats
        if failure:
            rec["failure"] = failure
        if error:
            rec["error"] = error[:300]
        return rec

    # --- reporting -------------------------------------------------------

    def _prom_gauges(self, pending: "list[Batch]") -> dict:
        """The service gauge set (the daemon layers its uptime/tenant
        family on top — runtime/daemon.py)."""
        statuses = [r.get("status") for r in self.job_records.values()]
        return {
            "shadow_tpu_sweep_queue_depth": len(pending),
            "shadow_tpu_sweep_clock_ns": self.clock_ns,
            "shadow_tpu_sweep_jobs_total": len(self.spec.jobs),
            "shadow_tpu_sweep_jobs_done": statuses.count("done"),
            "shadow_tpu_sweep_jobs_failed": statuses.count("failed"),
            "shadow_tpu_sweep_jobs_quarantined": statuses.count(
                "quarantined"
            ),
            "shadow_tpu_sweep_preemptions_total": sum(
                b.preemptions for b in self.batches
            ),
        }

    def _write_prom(self, pending: "list[Batch]") -> None:
        """Rewrite the service's Prometheus textfile snapshot (the scrape
        endpoint of a long-lived sweep — docs/service.md): job/queue
        gauges on top of the recorder's run-level ones."""
        rec = getattr(self, "recorder", None)
        if rec is None or not rec.prom_path:
            return
        rec.write_prom(extra_gauges=self._prom_gauges(pending))

    def _telemetry(self) -> dict:
        """The service-level telemetry block of sweep-manifest.json:
        queue-depth gauges per scheduling decision plus the tail of each
        job's probe-row series (full series stream via --metrics-file)."""
        return {
            "queue_depth": self.queue_depth_series[-100:],
            "max_queue_depth": max(
                (p["depth"] for p in self.queue_depth_series), default=0
            ),
            "per_job": {
                name: {
                    "samples": len(series),
                    "series_tail": series[-8:],
                }
                for name, series in self.job_series.items()
                if series
            },
        }

    def _manifest(self, wall: float) -> dict:
        from shadow_tpu_torch.runtime.ensemble import _agg

        jobs = [
            self.job_records.get(
                j.name,
                {"name": j.name, "status": "not-run"},
            )
            for j in self.spec.jobs
        ]
        done = [r for r in jobs if r.get("status") == "done"]
        aggregate = {}
        by_entry: "dict[str, list[dict]]" = {}
        for r in done:
            by_entry.setdefault(r["entry"], []).append(r)
        for entry, rs in sorted(by_entry.items()):
            aggregate[entry] = {
                metric: _agg([r["stats"][metric] for r in rs])
                for metric in ("events_handled", "packets_sent", "bytes_sent")
            }
        return {
            "sweep": self.spec.name,
            "output_dir": self.spec.output_dir,
            **({"mesh": self.spec.mesh} if self.mesh else {}),
            "wall_seconds": round(wall, 4),
            "service_clock_ns": self.clock_ns,
            "jobs_total": len(self.spec.jobs),
            "jobs_done": len(done),
            "jobs_failed": sum(1 for r in jobs if r.get("status") == "failed"),
            "jobs_quarantined": sum(
                1 for r in jobs if r.get("status") == "quarantined"
            ),
            # standalone-parity signal: `shadow-tpu run` exits nonzero on
            # unroutable packets, so the sweep's exit code must too
            "jobs_unroutable": sum(
                1
                for r in done
                if r.get("stats", {}).get("packets_unroutable", 0) > 0
            ),
            "preemptions": sum(b.preemptions for b in self.batches),
            "compile_cache": self.cache.stats(),
            "telemetry": self._telemetry(),
            "batches": [
                {**b.describe(), "status": b.status,
                 "wall_seconds": round(b.wall_seconds, 4),
                 "preemptions": b.preemptions, "recoveries": b.recoveries,
                 **({"failure": b.failure} if b.failure else {}),
                 **({"engine_fallbacks": b.engine_fallbacks}
                    if b.engine_fallbacks else {}),
                 **({"mesh_effective": b.mesh_effective}
                    if b.mesh_effective else {}),
                 **({"mesh_degradations": b.mesh_degradations}
                    if b.mesh_degradations else {}),
                 **({"error": b.error[:300]} if b.error else {})}
                for b in self.batches
            ],
            "jobs": jobs,
            "aggregate": aggregate,
        }


def render_report(manifest: dict) -> str:
    """The human-readable sweep-level report: one line per job plus the
    cross-job aggregate tables and the compile-cache accounting."""
    lines = [
        f"sweep {manifest['sweep']}: {manifest['jobs_done']}/"
        f"{manifest['jobs_total']} jobs done, "
        f"{manifest['jobs_failed']} failed, "
        f"{manifest.get('jobs_quarantined', 0)} quarantined, "
        f"{manifest['preemptions']} preemption(s), "
        f"{manifest['wall_seconds']:.2f}s wall",
        f"compile cache: {manifest['compile_cache']['compiles']} compile(s), "
        f"{manifest['compile_cache']['hits']} hit(s) "
        f"(hit rate {manifest['compile_cache']['hit_rate']:.2f}, "
        f"{manifest['compile_cache']['compile_seconds']:.2f}s compiling)",
        f"{'job':<24} {'seed':>5} {'prio':>4} {'batch':>5} {'status':<9} "
        f"{'events':>10} {'packets':>9}",
    ]
    for r in manifest["jobs"]:
        s = r.get("stats", {})
        # failed/quarantined jobs print their structured failure kind —
        # the stdout report mirrors sweep-manifest.json
        tail = ""
        if r.get("failure"):
            tail = f"  [{r['failure']}]"
        elif r.get("status") not in ("done", None) and r.get("error"):
            tail = f"  [{r['error'][:40]}]"
        lines.append(
            f"{r.get('name', '?'):<24} {r.get('seed', '?'):>5} "
            f"{r.get('priority', 0):>4} {r.get('batch', '-'):>5} "
            f"{r.get('status', '?'):<9} "
            f"{s.get('events_handled', '-'):>10} "
            f"{s.get('packets_sent', '-'):>9}{tail}"
        )
    for entry, table in manifest.get("aggregate", {}).items():
        ev = table["events_handled"]
        lines.append(
            f"aggregate [{entry}]: events mean={ev['mean']} "
            f"stddev={ev['stddev']} ci95={ev['ci95']}"
        )
    return "\n".join(lines)
