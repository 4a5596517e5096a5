"""Durable simulation daemon: `python -m shadow_tpu_torch serve SPOOL_DIR`
(port of shadow_tpu/runtime/daemon.py, copied with its imports rewritten
and its engine seams bound to the port's sweep service; batches run on
one device, `cuda` unless the daemon is asked for the CPU, `serve
--device cpu`).

The sweep scheduler (runtime/sweep.py) is a one-shot CLI: every job is
pre-declared, queue state lives in memory, and the AOT compile cache
dies with the process. This module promotes it to a **service** — and a
service is trustworthy only if it survives its own death without losing
work (the property ROADMAP item 5 named). Three mechanisms carry that
guarantee:

  * **Spool protocol** — jobs arrive live as YAML files dropped into
    ``SPOOL_DIR/incoming/`` (atomically: write elsewhere, rename in —
    ``shadow-tpu submit`` does this). Each file is one job entry
    (tenant, name, seeds, priority, scenario config); admission moves
    it to ``accepted/`` or ``rejected/`` with a structured reason.
  * **Crash-safe journal** — every admission, rejection, batch start,
    terminal job status, crash/resume, and clean shutdown is a
    write-ahead record in ``SPOOL_DIR/journal/``: one JSON file per
    record, atomic tmp+rename, sha-256 payload digest (the checkpoint
    plane's integrity idiom). A SIGKILL at ANY point — mid-admission,
    mid-batch, mid-checkpoint — loses zero accepted jobs: restart
    replays the journal, re-queues every admitted-but-unfinished job,
    resumes running batches from their latest valid checkpoint through
    the existing CheckpointManager/latest_path recovery path (jobs
    without one restart from scratch — and the journal's ``resume``
    record says which). A corrupt journal record (bit-rot, the
    ``spool-corrupt`` chaos fault) is skipped with a warning and its
    admission recovered from the archived spec in ``accepted/``.
  * **Multi-tenant admission control** — per-tenant quotas bound each
    tenant's outstanding jobs, a bounded queue provides backpressure
    (both reject with a journaled, structured record), and scheduling
    is weighted fair-share within each priority level: the tenant with
    the least weighted sim-time served runs next, so one tenant's
    100-job flood cannot starve another tenant's single urgent job.

Three serving-layer extensions ride the same admission path
(docs/service.md "HTTP front door"):

  * **HTTP front door** (``serve --http HOST:PORT``,
    runtime/httpapi.py) — network submission/status/results/events/
    metrics, every POST landing in the spool through the identical
    atomic-rename + journal path a file drop takes.
  * **Quota classes** (``--quota-class T=device_seconds:N[,queue:M]``)
    — the per-tenant device-seconds ledger, ENFORCED: over-budget
    admissions refuse with a journaled 429-equivalent carrying the
    refill window's Retry-After, and a running batch whose tenant runs
    dry parks (checkpoint + re-queue) at the next chunk boundary.
  * **Daemon fleet** — N serve processes share one spool: journal
    appends commit with no-overwrite links, per-batch claim files
    (owner + lease expiry, renewed at chunk ticks) make ownership
    exclusive, and a dead daemon's expired leases are stolen by
    survivors who resume from its newest checkpoint.

The compile cache is a PersistentCompileCache
(runtime/compile_cache.py) rooted in the spool, so a restarted daemon
— or a fleet peer — pays zero builds for worlds any daemon has already
prepared (on the card: no nvcc). `serve --mesh RxS` dispatches every
batch over a grid of logical devices (runtime/mesh.py), and a batch
checkpointed on one grid resumes on whatever grid the restarted daemon
has, the journal naming both. The chaos
plane closes the loop: ``daemon-kill`` / ``spool-corrupt`` /
``cache-corrupt`` faults (runtime/chaos.py) drive the soak test
(tests/test_daemon_soak.py) — 100+ jobs, 3 tenants, faults firing, and
the acceptance bar is zero lost jobs with the queue draining via
quarantine rather than collapse.
"""

from __future__ import annotations

import copy
import hashlib
import json
import os
import re
import signal
import threading
import time

import yaml

from shadow_tpu_torch.config.fingerprint import config_fingerprint
from shadow_tpu_torch.config.options import ConfigOptions, deep_merge
from shadow_tpu_torch.config.sweep import SweepJob, SweepSpec, _expand_seeds
from shadow_tpu_torch.runtime.compile_cache import PersistentCompileCache
from shadow_tpu_torch.runtime.sweep import Batch, SweepService
from shadow_tpu_torch.utils.shadow_log import slog

JOURNAL_VERSION = 1

# tenant and entry names become path components and prometheus label
# values — keep them boring
_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

_TERMINAL_TYPES = {
    "done": "job-done",
    "failed": "job-failed",
    "quarantined": "job-quarantined",
}


def _record_digest(rec: dict) -> str:
    """sha-256 over the record's canonical JSON minus its own digest
    field — re-derived and compared on replay, so a flipped byte in a
    journal record surfaces as a named skip, never a silently different
    queue state."""
    payload = {k: v for k, v in rec.items() if k != "sha256"}
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True, default=str).encode()
    ).hexdigest()


class Journal:
    """Append-only write-ahead journal with periodic compaction: one
    JSON file per record, named by sequence number, committed with the
    checkpoint plane's atomic-write + payload-digest idiom.

    Without compaction a months-long spool grows one file per record
    forever. `compact()` folds the durable STATE the records carry —
    terminal job statuses, rejection counts, admissions (live ones kept
    verbatim with their hermetic specs; fully-terminal ones folded to
    digests + job names) — into a sha-digested snapshot file
    (``snap-<through_seq>.json``), then deletes the record files it
    covers. Replay prefers snapshot + tail: the newest valid snapshot
    seeds the state and only records with seq > its through_seq are
    read. The two newest snapshots are retained (the checkpoint plane's
    keep=2 idiom), so one corrupt snapshot falls back to the previous
    one plus the accepted/ archive rescan — detected loudly by the
    digest, never a silently different queue state. A kill at ANY point
    of compaction is safe: the snapshot commit is atomic, stale records
    <= through_seq are simply ignored by replay, and deletions are
    idempotent (tests/test_daemon_cli.py pins kill-during-compaction).

    Operational records (batch-start, resume, shutdown) fold away
    entirely — only the last folded record's type survives as
    ``last_type`` for crash detection. Corrupt/unreadable records are
    skipped with a warning and counted (`corrupt_skipped`) — the
    daemon's accepted/ rescan recovers any admission whose record was
    lost."""

    _SNAP_RE = re.compile(r"^snap-(\d{8})\.json$")
    _REC_RE = re.compile(r"^r(\d{8})\.json$")

    def __init__(self, directory: str):
        self.directory = directory
        self.corrupt_skipped = 0
        self.snapshot: "dict | None" = None
        self.compactions = 0
        # tail_files value of the last compact() that found nothing
        # valid to fold (None = never stuck): the cadence check skips
        # until the count moves past it
        self._compact_stuck_at: "int | None" = None
        # append() is called from the drain loop AND the HTTP front
        # door's handler threads (runtime/httpapi.py) — one writer lock
        # per process; cross-process exclusivity is the link commit's job
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)
        self._rescan_seq(floor=0)

    def _rescan_seq(self, floor: "int | None" = None) -> None:
        """Re-derive the next free sequence number from the directory —
        construction, and the retry path after a fleet peer wins a
        sequence-number race."""
        names = os.listdir(self.directory)
        seqs = [
            int(m.group(1))
            for m in (self._REC_RE.match(f) for f in names)
            if m
        ]
        snaps = [
            int(m.group(1))
            for m in (self._SNAP_RE.match(f) for f in names)
            if m
        ]
        base = self._seq if floor is None else floor
        self._seq = max(
            [s + 1 for s in seqs] + [s + 1 for s in snaps] + [base]
        )
        self._tail_files = len(seqs)

    @property
    def count(self) -> int:
        return self._seq

    @property
    def tail_files(self) -> int:
        """Record FILES currently on disk (the growth compaction bounds;
        `count` keeps counting every record ever appended)."""
        return self._tail_files

    def _path(self, seq: int) -> str:
        return os.path.join(self.directory, f"r{seq:08d}.json")

    def _snap_path(self, through_seq: int) -> str:
        return os.path.join(self.directory, f"snap-{through_seq:08d}.json")

    def append(self, _type: str, **data) -> dict:
        from shadow_tpu_torch.runtime import chaos

        with self._lock:
            while True:
                rec = {
                    "seq": self._seq,
                    "version": JOURNAL_VERSION,
                    "type": _type,
                    "wall": round(time.time(), 3),
                    **data,
                }
                rec["sha256"] = _record_digest(rec)
                path = self._path(self._seq)
                tmp = f"{path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(rec, f)
                try:
                    # link-not-replace is the fleet-safe commit: when a
                    # peer daemon on the same spool claims this sequence
                    # number first, the link fails loudly and we retry
                    # at the next free seq (os.replace would silently
                    # swallow the peer's record)
                    os.link(tmp, path)
                except FileExistsError:
                    os.remove(tmp)
                    self._rescan_seq()
                    continue
                os.remove(tmp)
                break
            # chaos seam: bit-rot on a fully committed record — exactly
            # what the per-record digest and the accepted/ rescan defend
            # against
            if chaos.fire("spool-corrupt", at=rec["seq"]) is not None:
                chaos.damage_file(path, truncate=False)
            self._seq += 1
            self._tail_files += 1
            return rec

    def _load_snapshot(self) -> "dict | None":
        """The newest snapshot that passes its sha-256 check; a corrupt
        one is skipped with a warning and the previous one tried (its
        covered-but-not-yet-deleted records and the accepted/ rescan
        close the gap)."""
        snaps = sorted(
            (int(m.group(1)), f)
            for m, f in (
                (self._SNAP_RE.match(f), f)
                for f in os.listdir(self.directory)
            )
            if m
        )
        for _through, fname in reversed(snaps):
            path = os.path.join(self.directory, fname)
            try:
                with open(path) as f:
                    snap = json.load(f)
                if snap.get("sha256") != _record_digest(snap):
                    raise ValueError("payload failed its sha-256 check")
            except (OSError, ValueError) as e:
                self.corrupt_skipped += 1
                slog("warning", 0, "daemon",
                     f"skipping corrupt journal snapshot {path}: {e} — "
                     "falling back to the previous snapshot + records")
                continue
            return snap
        return None

    def _read_records(self, after_seq: int = -1) -> "list[dict]":
        records = []
        for fname in sorted(os.listdir(self.directory)):
            m = self._REC_RE.match(fname)
            if not m or int(m.group(1)) <= after_seq:
                continue
            path = os.path.join(self.directory, fname)
            try:
                with open(path) as f:
                    rec = json.load(f)
                if rec.get("sha256") != _record_digest(rec):
                    raise ValueError("payload failed its sha-256 check")
            except (OSError, ValueError) as e:
                self.corrupt_skipped += 1
                slog("warning", 0, "daemon",
                     f"skipping corrupt journal record {path}: {e} — "
                     "admissions will be recovered from accepted/ specs")
                continue
            records.append(rec)
        records.sort(key=lambda r: r.get("seq", 0))
        return records

    def replay(self) -> "list[dict]":
        """Valid TAIL records in sequence order: everything after the
        newest valid snapshot (left on self.snapshot; None when the
        journal was never compacted). Records a snapshot already covers
        are ignored even when still on disk — the kill-during-compaction
        invariant."""
        self.snapshot = self._load_snapshot()
        after = self.snapshot["through_seq"] if self.snapshot else -1
        return self._read_records(after_seq=after)

    def read_new(self, after_seq: int) -> "list[dict]":
        """Valid records with seq > after_seq currently on disk — the
        fleet-coherence read (a peer daemon's appends since our last
        look). Corrupt records are skipped WITHOUT recounting them into
        corrupt_skipped (a stable corrupt record would otherwise inflate
        the counter once per poll), and the next append is bumped past
        everything seen so our own records never trail a peer's."""
        skipped = self.corrupt_skipped
        recs = self._read_records(after_seq=after_seq)
        self.corrupt_skipped = skipped
        if recs:
            with self._lock:
                self._seq = max(self._seq, recs[-1]["seq"] + 1)
        return recs

    def compact(self) -> "dict | None":
        """Fold snapshot + all current records into a fresh snapshot and
        delete the record files it covers. Returns the new snapshot, or
        None when there was nothing to fold. Crash-ordering: snapshot
        commit (atomic) -> chaos kill seam -> deletions — so a SIGKILL
        anywhere leaves either the old state or a committed snapshot
        with redundant stale records, both of which replay identically."""
        from shadow_tpu_torch.runtime import chaos

        # replay() already counted this tail's corrupt records into
        # corrupt_skipped; re-reading here must not double-report them
        skipped_before = self.corrupt_skipped
        prev = self._load_snapshot()
        after = prev["through_seq"] if prev else -1
        tail = self._read_records(after_seq=after)
        self.corrupt_skipped = skipped_before
        if not tail:
            # nothing valid to fold (e.g. an all-corrupt tail): remember
            # the file count so the cadence check does not re-scan every
            # idle tick until new records actually land
            self._compact_stuck_at = self._tail_files
            return None
        snap = _fold_records(prev, tail)
        snap["sha256"] = _record_digest(snap)
        path = self._snap_path(snap["through_seq"])
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(snap, f)
        os.replace(tmp, path)
        self.compactions += 1
        # chaos seam (tags=("compact",)): SIGKILL between the snapshot
        # commit and the deletions below — restart must replay the same
        # state from snapshot + (now-redundant) stale records
        if chaos.fire("daemon-kill", at=self.compactions - 1,
                      tags=("compact",)) is not None:
            slog("warning", 0, "chaos",
                 "injected fault: daemon-kill during journal compaction "
                 "— SIGKILL now")
            os.kill(os.getpid(), signal.SIGKILL)
        removed = 0
        for fname in list(os.listdir(self.directory)):
            m = self._REC_RE.match(fname)
            if m and int(m.group(1)) <= snap["through_seq"]:
                try:
                    os.remove(os.path.join(self.directory, fname))
                    removed += 1
                except OSError:
                    pass
            ms = self._SNAP_RE.match(fname)
            if ms and int(ms.group(1)) < (after if prev else -1):
                # keep exactly the new snapshot and its predecessor
                try:
                    os.remove(os.path.join(self.directory, fname))
                except OSError:
                    pass
        self._tail_files = max(0, self._tail_files - removed)
        self.snapshot = snap
        slog("info", 0, "daemon",
             f"compacted journal: {removed} record file(s) folded into "
             f"{os.path.basename(path)} "
             f"({len(snap['admits'])} live admission(s), "
             f"{len(snap['folded_admits'])} folded, "
             f"{len(snap['terminal'])} terminal job(s))")
        return snap


def _fold_records(prev: "dict | None", tail: "list[dict]") -> dict:
    """The compaction fold: durable state out, operational history off.
    Admissions whose jobs are ALL terminal drop their embedded spec
    (the accepted/ archive keeps the hermetic copy) and keep only the
    digests + names replay needs for idempotency; live admissions are
    kept verbatim so _replay_admit can re-queue them."""
    terminal = dict((prev or {}).get("terminal", {}))
    rejected = dict((prev or {}).get("rejected", {}))
    admits: "dict[str, dict]" = {
        r["spec_sha256"]: r for r in (prev or {}).get("admits", [])
    }
    folded: "dict[str, dict]" = {
        r["spec_sha256"]: r for r in (prev or {}).get("folded_admits", [])
    }
    last_type = (prev or {}).get("last_type")
    for rec in tail:
        t = rec.get("type")
        last_type = t
        if t == "admit":
            admits[rec.get("spec_sha256")] = rec
        elif t in ("job-done", "job-failed", "job-quarantined"):
            terminal[rec.get("job")] = t[len("job-"):]
        elif t == "reject":
            tn = rec.get("tenant") or "?"
            rejected[tn] = rejected.get(tn, 0) + 1
    for sha, rec in list(admits.items()):
        names = rec.get("jobs", [])
        if names and all(n in terminal for n in names):
            folded[sha] = {
                k: rec.get(k)
                for k in ("spec_sha256", "source_sha256", "tenant",
                          "entry", "jobs", "seeds", "priority",
                          "spec_file")
                if rec.get(k) is not None
            }
            del admits[sha]
    return {
        "type": "snapshot",
        "version": JOURNAL_VERSION,
        "through_seq": tail[-1]["seq"],
        "wall": round(time.time(), 3),
        "last_type": last_type,
        "terminal": terminal,
        "rejected": rejected,
        "admits": list(admits.values()),
        "folded_admits": list(folded.values()),
    }


def parse_spool_spec(text: str, spool_dir: str,
                     default_tenant: str = "default"):
    """Parse one spool spec file into (tenant, entry, jobs,
    canonical_text).

    `canonical_text` is the spec with a `base:` reference REPLACED by
    the loaded config and seed ranges expanded — the hermetic form the
    journal embeds and the archive stores, so a replay can never be
    changed by edits to an external base file after admission
    (re-parsing the canonical text always rebuilds the admitted
    world).

    Format — a single ``job`` mapping::

        job:
          tenant: alice            # default "default"
          name: ph                 # entry name, unique per tenant
          seeds: [0, 1]            # and/or seed_range: [lo, hi)
          priority: 0              # higher preempts lower
          config: {...}            # inline scenario mapping, or
          # base: /abs/path.yaml   # an absolute config path
          overrides: {...}         # deep-merged over config/base

    Every (entry, seed) expands to one validated single-world SweepJob
    named ``<tenant>.<entry>-s<seed>`` with its data directory under
    ``<spool>/jobs/``. Deterministic: re-parsing the same text yields
    the same jobs — the journal-replay contract."""
    raw = yaml.safe_load(text)
    if not isinstance(raw, dict) or "job" not in raw:
        raise ValueError("spool spec must be a mapping with a 'job' section")
    j = dict(raw["job"])
    tenant = str(j.pop("tenant", default_tenant))
    ename = str(j.pop("name", ""))
    for label, val in (("tenant", tenant), ("name", ename)):
        if not _NAME_RE.match(val or ""):
            raise ValueError(
                f"job.{label} {val!r} must match {_NAME_RE.pattern} "
                "(it names directories and metric labels)"
            )
    seeds = _expand_seeds(ename, j)
    priority = int(j.pop("priority", 0))
    base_cfg = j.pop("config", None)
    base_path = j.pop("base", None)
    if (base_cfg is None) == (base_path is None):
        raise ValueError(
            "spool spec needs exactly one of 'config' (inline scenario) "
            "or 'base' (an absolute config path)"
        )
    if base_path is not None:
        if not os.path.isabs(base_path):
            raise ValueError(
                "job.base must be an absolute path — spool files are "
                "archived after admission, so a relative path would "
                "dangle (prefer an inline 'config')"
            )
        with open(base_path) as f:
            base_cfg = yaml.safe_load(f.read())
    if not isinstance(base_cfg, dict):
        raise ValueError("spool spec config must be a mapping")
    overrides = j.pop("overrides", {}) or {}
    if not isinstance(overrides, dict):
        raise ValueError("job.overrides must be a mapping")
    if j:
        raise ValueError(f"unknown key(s) in job: {sorted(j)}")
    merged = deep_merge(base_cfg, overrides)
    if "chaos" in merged:
        raise ValueError(
            "chaos is daemon-global (serve --chaos-seed/--chaos-fault); "
            "a per-job chaos section would be silently ignored"
        )
    jobs: "list[SweepJob]" = []
    for seed in seeds:
        job_raw = copy.deepcopy(merged)
        g = job_raw.setdefault("general", {})
        g["seed"] = seed
        jname = f"{tenant}.{ename}-s{seed}"
        g["data_directory"] = os.path.join(spool_dir, "jobs", jname)
        cfg = ConfigOptions.from_dict(copy.deepcopy(job_raw))
        if cfg.general.replicas != 1:
            raise ValueError(
                f"job {ename!r}: spool jobs are single-world configs; "
                "the daemon owns replica batching — drop general.replicas"
            )
        if cfg.general.mesh is not None:
            raise ValueError(
                f"job {ename!r}: spool jobs are single-world configs; "
                "the daemon owns the mesh layout (serve --mesh RxS) — "
                "drop general.mesh"
            )
        jobs.append(
            SweepJob(
                name=jname,
                entry=ename,
                seed=seed,
                priority=priority,
                arrival_ns=0,
                config=cfg,
                raw_config=job_raw,
                group_key=config_fingerprint(cfg, exclude_seed=True),
            )
        )
    canonical_text = yaml.safe_dump(
        {
            "job": {
                "tenant": tenant,
                "name": ename,
                "seeds": seeds,
                "priority": priority,
                "config": base_cfg,
                **({"overrides": overrides} if overrides else {}),
            }
        },
        sort_keys=False,
    )
    return tenant, ename, jobs, canonical_text


def parse_quota_class(arg: str) -> "tuple[str, dict]":
    """Parse one `--quota-class T=device_seconds:N[,queue:M]` argument
    into (tenant, {"device_seconds": float, "queue": int | None}).
    `device_seconds` is the tenant's budget per refill window (serve
    --quota-window); `queue` overrides the tenant's outstanding-job
    quota. Enforcement lives in DaemonService (docs/service.md "Quota
    classes")."""
    if "=" not in arg:
        raise ValueError(
            f"quota-class {arg!r} must be "
            "TENANT=device_seconds:N[,queue:M]"
        )
    tenant, _, body = arg.partition("=")
    tenant = tenant.strip()
    if not _NAME_RE.match(tenant):
        raise ValueError(f"quota-class tenant {tenant!r} is not a name")
    out: dict = {"device_seconds": None, "queue": None}
    for part in body.split(","):
        key, sep, val = part.partition(":")
        key = key.strip()
        if not sep or key not in out:
            raise ValueError(
                f"quota-class {arg!r}: bad term {part!r} (want "
                "device_seconds:N or queue:M)"
            )
        try:
            out[key] = float(val) if key == "device_seconds" else int(val)
        except ValueError:
            raise ValueError(
                f"quota-class {arg!r}: {key} value {val!r} is not a number"
            ) from None
        floor = 0 if key == "device_seconds" else 1
        if out[key] < floor:
            raise ValueError(
                f"quota-class {arg!r}: {key} must be >= {floor}"
            )
    if out["device_seconds"] is None:
        raise ValueError(
            f"quota-class {arg!r} needs a device_seconds:N budget"
        )
    return tenant, out


def _percentiles(samples: "list[float]") -> dict:
    """p50/p90/p99 by the nearest-rank method — the admission-latency
    summary of daemon-manifest.json and bench detail.service."""
    if not samples:
        return {}
    xs = sorted(samples)
    n = len(xs)
    return {
        # nearest-rank: index ceil(p/100 * n) - 1, clamped
        f"p{p}": round(xs[min(n - 1, max(0, -(-(p * n) // 100) - 1))], 6)
        for p in (50, 90, 99)
    }


class DaemonService(SweepService):
    """The persistent daemon: a SweepService whose queue is fed by the
    spool, journaled through the WAL, scheduled with per-tenant
    weighted fair-share, and backed by a disk-persistent compile cache.
    One instance per `shadow-tpu serve` process; all durable state
    lives in the spool directory, so a new instance on the same spool
    IS the restarted daemon."""

    def __init__(
        self,
        spool_dir: str,
        *,
        capacity: int = 8,
        retry_max: int = 1,
        retry_backoff_s: float = 0.0,
        default_quota: int = 64,
        quotas: "dict[str, int] | None" = None,
        weights: "dict[str, float] | None" = None,
        max_queue: int = 256,
        poll_interval_s: float = 2.0,
        prom_interval_s: float = 10.0,
        keep_batch_dirs: int = 8,
        drain: bool = False,
        cache_dir: "str | None" = None,
        persist_cache: bool = True,
        metrics_file: "str | None" = None,
        metrics_max_mb: float = 64.0,
        metrics_keep: int = 3,
        metrics_prom: "str | None" = None,
        default_tenant: str = "default",
        mesh: "str | None" = None,
        journal_compact_every: int = 512,
        http: "str | None" = None,
        quota_classes: "dict[str, dict] | None" = None,
        quota_window_s: float = 3600.0,
        lease_s: float = 30.0,
        daemon_id: "str | None" = None,
        device="cuda",
    ):
        from shadow_tpu_torch.device import resolve_device

        device = resolve_device(device)
        self.spool_dir = os.path.abspath(spool_dir)
        for sub in ("incoming", "accepted", "rejected", "journal",
                    "jobs", "batches", "claims"):
            os.makedirs(os.path.join(self.spool_dir, sub), exist_ok=True)
        spec = SweepSpec(
            name="daemon",
            output_dir=self.spool_dir,
            capacity=capacity,
            jobs=[],
            retry_max=retry_max,
            retry_backoff_s=retry_backoff_s,
            mesh=mesh,
        )
        cache = None
        if persist_cache:
            cache = PersistentCompileCache(
                cache_dir or os.path.join(self.spool_dir, "cache"), device=device
            )
        super().__init__(
            spec, metrics_file=metrics_file, metrics_prom=metrics_prom,
            cache=cache, device=device,
        )
        self.journal = Journal(os.path.join(self.spool_dir, "journal"))
        # journal compaction cadence: fold terminal records into a
        # snapshot once this many record FILES accumulate (0 = never —
        # the pre-compaction behavior)
        self.journal_compact_every = int(journal_compact_every)
        self.default_quota = int(default_quota)
        self.quotas = {str(k): int(v) for k, v in (quotas or {}).items()}
        self.weights = {str(k): float(v) for k, v in (weights or {}).items()}
        self.max_queue = int(max_queue)
        self.poll_interval_s = float(poll_interval_s)
        self.prom_interval_s = float(prom_interval_s)
        self.keep_batch_dirs = int(keep_batch_dirs)
        self.drain_mode = bool(drain)
        self.metrics_max_mb = float(metrics_max_mb)
        self.metrics_keep = int(metrics_keep)
        self.default_tenant = default_tenant
        # durable-state mirrors, rebuilt from the journal on start
        self._admitted_digests: "dict[str, dict]" = {}
        self._entries: "set[tuple[str, str]]" = set()
        self._job_tenant: "dict[str, str]" = {}
        self._terminal: "dict[str, str]" = {}  # job -> terminal status
        # incrementally maintained outstanding counts (tenant -> jobs
        # admitted and not yet terminal): quota checks and the prom
        # gauge family read these at hot cadence, and a scan of every
        # job ever admitted would grow with daemon lifetime
        self._outstanding_t: "dict[str, int]" = {}
        # jobs this run marked failed during journal replay (a spec
        # that no longer validates): surfaced in the manifest and the
        # serve exit code — they are failures of THIS run's replay
        self.replay_failed = 0
        self._rejected: "dict[str, int]" = {}  # tenant -> rejections
        self.tenant_service: "dict[str, float]" = {}  # weighted sim-ns
        # per-tenant device-seconds SERVED (resource-class quotas want
        # device time, not job counts): wall-seconds of batch execution
        # times the logical devices its grid occupies, accumulated at
        # chunk cadence; the quota classes below enforce budgets against it
        self.tenant_device_seconds: "dict[str, float]" = {}
        self._batch_wall_anchor: "float | None" = None
        self._anchor_tenant: str = default_tenant
        self._anchor_devices: int = 1
        self.resume_report: "dict | None" = None
        self.pending: "list[Batch]" = []
        self._stop = False
        self._prev_signals: dict = {}
        self._t0 = time.monotonic()
        self._admit_ord = 0
        self._batch_ord = 0
        self._chunk_ticks = 0
        self._last_poll_wall = float("-inf")
        self._last_prom_wall = float("-inf")
        self._manifest_doc: "dict | None" = None
        # --- front door (runtime/httpapi.py) -----------------------------
        self.http_addr = http
        self.front_door = None  # built in run() when http_addr is set
        # --- quota classes (enforced device-seconds budgets) -------------
        self.quota_classes = {
            str(t): dict(c) for t, c in (quota_classes or {}).items()
        }
        self.quota_window_s = max(float(quota_window_s), 1e-3)
        self._window_start = time.monotonic()
        # tenant_device_seconds snapshot at the window's start: spend
        # WITHIN the window = current - base, so a refill is just a new
        # base — the ledger itself never resets
        self._window_base: "dict[str, float]" = {}
        self._parked_note: "set[str]" = set()  # park journaled once/run
        # --- fleet claims (one spool, N daemons) -------------------------
        self.lease_s = max(float(lease_s), 0.1)
        self.daemon_id = daemon_id or f"{os.uname().nodename}.{os.getpid()}"
        self.leases_held = 0
        self.claims_stolen = 0
        self._lease_lost = False
        self._lease_renew_wall = float("-inf")
        self._renew_ord = 0
        # highest journal seq already folded into the state mirrors —
        # _refresh_journal reads past it to absorb fleet peers' records
        self._refresh_seq = -1
        # --- admission latency (arrival -> journaled admit) --------------
        self._admit_latencies: "list[float]" = []
        # --- per-job progress pub-sub (HTTP event streams) ---------------
        self._subs_lock = threading.Lock()
        self._progress_subs: "dict[str, list]" = {}

    # --- paths -----------------------------------------------------------

    def _sub(self, name: str) -> str:
        return os.path.join(self.spool_dir, name)

    def _dir_key(self, tenant: str, entry: str) -> str:
        return f"{tenant}.{entry}"

    # --- lifecycle -------------------------------------------------------

    def run(self) -> dict:
        """Serve: replay the journal (crash recovery), then drain the
        spool — forever in daemon mode (SIGTERM/SIGINT drain to a
        checkpoint and exit cleanly), or until idle with --drain.
        Returns (and writes) daemon-manifest.json."""
        from shadow_tpu_torch.runtime.flightrec import FlightRecorder

        t0 = time.perf_counter()
        slog("info", 0, "daemon",
             f"daemon {self.daemon_id} serving {self.spool_dir}, device={self.device}")
        self.recorder = FlightRecorder(
            blackbox_path=os.path.join(self.spool_dir, "flight-recorder.json"),
            metrics_path=self.metrics_file,
            metrics_max_bytes=int(self.metrics_max_mb * 1_000_000),
            metrics_keep=self.metrics_keep,
            prom_path=self.metrics_prom,
        )
        self._install_signals()
        if self.http_addr:
            from shadow_tpu_torch.runtime.httpapi import FrontDoor

            self.front_door = FrontDoor(self, self.http_addr)
            self.front_door.start()
        clean = False
        try:
            self._replay()
            self._drain(self.pending)
            clean = True
        finally:
            if self.front_door is not None:
                self.front_door.stop()
            self._restore_signals()
            try:
                if clean:
                    # a SIGKILL skips this record, which is exactly how
                    # the next start detects the crash
                    self.journal.append(
                        "shutdown", clean=True, stopped=self._stop,
                        pending_jobs=self._outstanding(),
                    )
                # close() first — its plain write_prom must not clobber
                # the daemon gauge snapshot written after it
                self.recorder.close()
                self._write_prom(self.pending)
            finally:
                self._manifest_doc = self._daemon_manifest(
                    time.perf_counter() - t0
                )
                self._write_manifest()
        return self._manifest_doc

    def _install_signals(self) -> None:
        if threading.current_thread() is not threading.main_thread():
            return

        def handle(signum, frame):
            self._stop = True
            slog("info", 0, "daemon",
                 "shutdown requested: the running batch checkpoints at "
                 "its next chunk boundary, then the daemon exits cleanly "
                 "(restart resumes bit-exact)")
            self._restore_signals()  # a second signal kills the old way

        for sig in (signal.SIGINT, signal.SIGTERM):
            self._prev_signals[sig] = signal.signal(sig, handle)

    def _restore_signals(self) -> None:
        for sig, prev in list(self._prev_signals.items()):
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_signals.clear()

    # --- journal replay (crash recovery) ---------------------------------

    def _replay(self) -> None:
        records = self.journal.replay()
        snap = self.journal.snapshot
        crashed = bool(records) and records[-1].get("type") != "shutdown"
        if not records and snap is not None:
            # an empty tail means the last record before compaction
            # carries the crash signal — the snapshot folded its type
            crashed = snap.get("last_type") != "shutdown"
        admits: "list[dict]" = []
        if snap is not None:
            # replay prefers snapshot + tail: the folded state seeds the
            # mirrors FIRST so tail records and live admissions layer on
            # top (terminal before admits keeps outstanding counts right)
            self._terminal.update(snap.get("terminal", {}))
            for tn, n in snap.get("rejected", {}).items():
                self._rejected[tn] = self._rejected.get(tn, 0) + int(n)
            for rec in snap.get("folded_admits", []):
                self._register_admit(
                    rec.get("tenant") or self.default_tenant,
                    rec.get("entry") or "?", rec, rec.get("jobs", []),
                )
            admits.extend(snap.get("admits", []))
        for rec in records:
            t = rec.get("type")
            if t == "admit":
                admits.append(rec)
            elif t in ("job-done", "job-failed", "job-quarantined"):
                self._terminal[rec.get("job")] = t[len("job-"):]
            elif t == "reject":
                tn = rec.get("tenant") or "?"
                self._rejected[tn] = self._rejected.get(tn, 0) + 1
        admits.extend(self._recover_lost_admits(admits))
        resumed: "list[dict]" = []
        for rec in admits:
            resumed.extend(self._replay_admit(rec))
        # everything on disk so far is folded into the mirrors; the
        # fleet refresh starts past it (peers' appends land later)
        self._refresh_seq = self.journal.count - 1
        if records or resumed or snap is not None:
            self.resume_report = {
                "crashed": crashed,
                "journal_records": len(records),
                "corrupt_skipped": self.journal.corrupt_skipped,
                "pending_jobs": self._outstanding(),
                "batches": resumed,
            }
            self.journal.append("resume", **self.resume_report)
            if crashed:
                slog("warning", 0, "daemon",
                     f"previous daemon did not shut down cleanly; "
                     f"{self._outstanding()} admitted job(s) re-queued "
                     f"({sum(1 for b in resumed if b['checkpoint'])} "
                     "batch(es) resume from checkpoints)")

    def _recover_lost_admits(self, admits: "list[dict]") -> "list[dict]":
        """The spool-corrupt recovery path: any spec archived in
        accepted/ whose digest has no valid admit record lost that
        record to corruption — re-journal it from the archived file
        (the journal and the archive are two independent copies of
        every admission; losing one must lose nothing)."""
        # folded (compacted) admissions are known through the digest
        # mirror, not the admit list — without them every long-finished
        # spec in accepted/ would re-journal after each compaction
        known = {r.get("spec_sha256") for r in admits} | set(
            self._admitted_digests
        )
        recovered = []
        for fname in sorted(os.listdir(self._sub("accepted"))):
            path = os.path.join(self._sub("accepted"), fname)
            try:
                with open(path) as f:
                    text = f.read()
            except OSError:
                continue
            digest = hashlib.sha256(text.encode()).hexdigest()
            if digest in known:
                continue
            try:
                tenant, entry, jobs, _canon = parse_spool_spec(
                    text, self.spool_dir, self.default_tenant
                )
            except (ValueError, yaml.YAMLError) as e:
                slog("warning", 0, "daemon",
                     f"accepted spec {fname} has no journal record and "
                     f"does not parse ({e}); skipping")
                continue
            slog("warning", 0, "daemon",
                 f"re-journaling admission of {fname} (its journal "
                 "record was lost to corruption)")
            # archived specs are already canonical (hermetic): embed
            # the file text itself, whose digest is `digest`
            rec = self.journal.append(
                "admit", recovered=True, tenant=tenant, entry=entry,
                jobs=[j.name for j in jobs], seeds=[j.seed for j in jobs],
                priority=jobs[0].priority, spec_sha256=digest,
                spec_file=fname, spec=text,
            )
            known.add(digest)
            recovered.append(rec)
        return recovered

    def _replay_admit(self, rec: dict) -> "list[dict]":
        """Re-expand one journaled admission; queue its non-terminal
        jobs, resuming each re-packed batch from its newest valid
        checkpoint when one exists for the exact batch config. Returns
        the per-batch resume entries for the `resume` journal record."""
        tenant = rec.get("tenant") or self.default_tenant
        entry = rec.get("entry") or "?"
        try:
            tenant, entry, jobs, _canon = parse_spool_spec(
                rec["spec"], self.spool_dir, self.default_tenant
            )
            self.validate_jobs(jobs)
        except (KeyError, ValueError, yaml.YAMLError) as e:
            # the spec was valid when admitted; it no longer is (config
            # drift across versions). The jobs must not vanish silently:
            # each gets a terminal, journaled `failed` record, counted
            # into replay_failed so the manifest and the serve exit
            # code report them as THIS run's failures.
            for jn in rec.get("jobs", []):
                self._job_tenant.setdefault(jn, tenant)
                if jn not in self._terminal:
                    self._mark_terminal(jn, "failed")
                    self.replay_failed += 1
                    self.journal.append(
                        "job-failed", job=jn, failure="config",
                        error=str(e)[:300],
                    )
            slog("warning", 0, "daemon",
                 f"journaled admission {entry!r} no longer validates "
                 f"({e}); its unfinished jobs are recorded failed")
            return []
        self._register_admit(tenant, entry, rec, jobs)
        left = [j for j in jobs if j.name not in self._terminal]
        if not left:
            return []
        for j in left:
            j.arrival_ns = self.clock_ns
        batches = self.enqueue(
            left, tenant=tenant, dir_key=self._dir_key(tenant, entry)
        )
        self.pending.extend(batches)
        out = []
        for b in batches:
            from shadow_tpu_torch.runtime.checkpoint import (
                CheckpointManager,
                peek_checkpoint_meta,
            )

            ckpt_dir = os.path.join(self._batch_dir(b), "ckpts")
            path = CheckpointManager.latest_path(ckpt_dir)
            saved_grid = None
            if path is not None:
                # only resume the exact simulated WORLD the checkpoint
                # was written for — anything else restarts from scratch.
                # The fingerprint does not pin the grid: a checkpoint
                # written on another mesh resumes here, resharded onto
                # this daemon's grid at dispatch
                try:
                    meta = peek_checkpoint_meta(path)
                    saved_grid = meta.get("mesh")
                    want = config_fingerprint(self._batch_config(b))
                    if meta.get("fingerprint") != want:
                        path = None
                except Exception:  # noqa: BLE001 — unusable = scratch
                    path = None
            b.resume_ckpt = path
            entry = {
                "key": b.dir_key,
                "jobs": [j.name for j in b.jobs],
                "checkpoint": path,
            }
            if path is not None:
                # the grid the checkpoint was written on, and the grid this
                # daemon resumes it on
                entry["mesh"] = saved_grid
                entry["mesh_resume"] = self._batch_grid(b)
            out.append(entry)
        return out

    def _register_admit(self, tenant, entry, rec, jobs) -> None:
        # both digests dedupe: spec_sha256 is the canonical (hermetic)
        # text the journal/archive hold; source_sha256 the original
        # incoming file, so re-dropping either form is idempotent.
        # `jobs` takes SweepJobs or bare names (compacted folded_admits
        # carry names only — the specs live in accepted/).
        self._admitted_digests[rec["spec_sha256"]] = rec
        if rec.get("source_sha256"):
            self._admitted_digests[rec["source_sha256"]] = rec
        self._entries.add((tenant, entry))
        self._outstanding_t.setdefault(tenant, 0)
        for j in jobs:
            name = j if isinstance(j, str) else j.name
            if name not in self._job_tenant:
                self._job_tenant[name] = tenant
                if name not in self._terminal:
                    self._outstanding_t[tenant] += 1

    def _mark_terminal(self, name: str, status: str) -> bool:
        """Record a terminal status, decrementing the owner tenant's
        outstanding counter exactly once. Returns False when the job
        was already terminal."""
        if name in self._terminal:
            self._terminal[name] = status
            return False
        self._terminal[name] = status
        t = self._job_tenant.get(name)
        if t is not None and self._outstanding_t.get(t, 0) > 0:
            self._outstanding_t[t] -= 1
        return True

    # --- admission (the spool scan) --------------------------------------

    def _outstanding(self, tenant: "str | None" = None) -> int:
        if tenant is not None:
            return self._outstanding_t.get(tenant, 0)
        return sum(self._outstanding_t.values())

    def _scan_spool(self, pending: "list[Batch]") -> None:
        inc = self._sub("incoming")
        try:
            names = sorted(os.listdir(inc))
        except OSError:
            return
        for name in names:
            if not name.endswith((".yaml", ".yml")) or name.startswith("."):
                continue  # tmp files mid-rename, editor droppings
            self._admit_file(os.path.join(inc, name), pending)

    def _admit_file(self, path: str, pending: "list[Batch]") -> None:
        from shadow_tpu_torch.runtime import chaos

        name = os.path.basename(path)
        try:
            with open(path) as f:
                text = f.read()
            spool_mtime = os.stat(path).st_mtime
        except OSError:
            return  # racing the producer's rename; next scan gets it
        # arrival stamp for the admission-latency percentiles: the
        # submitter's nanosecond filename prefix (submit_spec and the
        # HTTP front door both write it) beats the coarser spool mtime
        m = re.match(r"^(\d{20})-", name)
        arrival_wall = int(m.group(1)) / 1e9 if m else spool_mtime
        digest = hashlib.sha256(text.encode()).hexdigest()
        if digest in self._admitted_digests:
            # already journaled: a crash between journal and archive, or
            # the same spec dropped twice — admission is idempotent (the
            # archive copy is restored from the record's canonical text)
            rec = self._admitted_digests[digest]
            self._archive(path, rec["spec_sha256"], rec.get("spec"))
            return
        try:
            tenant, entry, jobs, canon = parse_spool_spec(
                text, self.spool_dir, self.default_tenant
            )
        except (ValueError, yaml.YAMLError) as e:
            self._reject(path, name, digest, None, "parse", str(e))
            return
        canon_digest = hashlib.sha256(canon.encode()).hexdigest()
        if (tenant, entry) in self._entries:
            self._reject(
                path, name, digest, tenant, "duplicate",
                f"entry {entry!r} is already admitted for tenant "
                f"{tenant!r} (submit under a new name)",
            )
            return
        self._roll_window()
        rem = self._budget_remaining(tenant)
        if rem is not None and rem <= 0:
            # the 429-equivalent: journaled, structured, and carrying
            # the ledger's refill horizon as Retry-After — the HTTP
            # front door mirrors this record verbatim
            self._reject(
                path, name, digest, tenant, "quota-class",
                f"tenant {tenant!r} exhausted its device-seconds budget "
                f"({self.quota_classes[tenant]['device_seconds']:g}s per "
                f"{self.quota_window_s:g}s window)",
                retry_after_s=self._retry_after_s(),
            )
            return
        quota = self.quotas.get(tenant, self.default_quota)
        qc = self.quota_classes.get(tenant)
        if qc is not None and qc.get("queue") is not None:
            quota = qc["queue"]
        held = self._outstanding(tenant)
        if held + len(jobs) > quota:
            self._reject(
                path, name, digest, tenant, "quota",
                f"tenant {tenant!r} holds {held} outstanding job(s); "
                f"admitting {len(jobs)} more would exceed its quota "
                f"of {quota}",
            )
            return
        total = self._outstanding()
        if total + len(jobs) > self.max_queue:
            self._reject(
                path, name, digest, tenant, "backpressure",
                f"queue holds {total} outstanding job(s); admitting "
                f"{len(jobs)} more would exceed the bound of "
                f"{self.max_queue} — resubmit when the queue drains",
            )
            return
        try:
            self.validate_jobs(jobs)
        except ValueError as e:
            self._reject(path, name, digest, tenant, "config", str(e))
            return
        # ---- admission commits: journal (the WAL) -> archive -> queue.
        # A crash after the journal write loses nothing: replay re-queues
        # from the record, and the idempotent-digest path re-archives a
        # file left in incoming/.
        # the journal embeds the CANONICAL spec (base: inlined, seeds
        # expanded), so a replay can never be changed by later edits to
        # an external base file — the admitted world is pinned here
        admit_latency_s = round(max(0.0, time.time() - arrival_wall), 6)
        rec = self.journal.append(
            "admit", tenant=tenant, entry=entry,
            jobs=[j.name for j in jobs], seeds=[j.seed for j in jobs],
            priority=jobs[0].priority, spec_sha256=canon_digest,
            source_sha256=digest, spec_file=name, spec=canon,
            admit_latency_s=admit_latency_s,
        )
        self._admit_latencies.append(admit_latency_s)
        del self._admit_latencies[:-512]
        self._register_admit(tenant, entry, rec, jobs)
        if chaos.fire("daemon-kill", at=self._admit_ord,
                      tags=("admit",)) is not None:
            self._kill_self(f"admission {self._admit_ord}")
        self._admit_ord += 1
        self._archive(path, canon_digest, canon)
        for j in jobs:
            j.arrival_ns = self.clock_ns
        batches = self.enqueue(
            jobs, tenant=tenant, dir_key=self._dir_key(tenant, entry)
        )
        pending.extend(batches)
        slog("info", self.clock_ns, "daemon",
             f"admitted {name}: tenant {tenant}, entry {entry}, "
             f"{len(jobs)} job(s) in {len(batches)} batch(es) "
             f"(priority {jobs[0].priority})")
        rec2 = getattr(self, "recorder", None)
        if rec2 is not None:
            rec2.event("admit", tenant=tenant, entry=entry,
                       jobs=len(jobs), file=name)

    def _archive(self, path: str, digest: str,
                 text: "str | None" = None) -> None:
        """Archive an admitted spec under its canonical digest. `text`
        (the canonical form) is written when it differs from the
        incoming file; the original is removed either way."""
        dest = os.path.join(
            self._sub("accepted"), f"{digest[:12]}-{os.path.basename(path)}"
        )
        try:
            if text is None:
                os.replace(path, dest)
                return
            tmp = f"{dest}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, dest)
            os.remove(path)
        except OSError:
            pass

    def _reject(self, path, name, digest, tenant, reason, detail,
                **extra) -> None:
        """Bounded-queue / quota / bad-spec refusal: a structured,
        journaled record plus a reply file next to the moved spec — the
        submitter can read WHY without grepping daemon logs. `extra`
        rides into the record (quota-class refusals carry
        retry_after_s, the ledger's refill horizon)."""
        rec = self.journal.append(
            "reject", file=name, tenant=tenant, reason=reason,
            detail=str(detail)[:400], spec_sha256=digest, **extra,
        )
        tn = tenant or "?"
        self._rejected[tn] = self._rejected.get(tn, 0) + 1
        dest = os.path.join(self._sub("rejected"), f"{digest[:12]}-{name}")
        try:
            os.replace(path, dest)
            with open(f"{dest}.reason.json", "w") as f:
                json.dump(rec, f, indent=2)
        except OSError:
            pass
        slog("warning", self.clock_ns, "daemon",
             f"rejected {name} ({reason}): {detail}")
        rec2 = getattr(self, "recorder", None)
        if rec2 is not None:
            rec2.event("reject", tenant=tenant, reason=reason, file=name)

    def _kill_self(self, site: str) -> None:
        slog("warning", 0, "chaos",
             f"injecting fault: daemon-kill at {site} — SIGKILL now")
        os.kill(os.getpid(), signal.SIGKILL)

    # --- fleet coherence (N daemons, one spool) --------------------------

    def _refresh_journal(self, pending: "list[Batch]") -> None:
        """Absorb journal records fleet peers appended since our last
        look: their terminal records settle jobs we hold pending (the
        peer ran them), their admit records hand us their queue (so a
        dead peer's batches are claimable here). Idempotent — our own
        records re-read on the way are no-ops against the mirrors."""
        for rec in self.journal.read_new(self._refresh_seq):
            self._refresh_seq = max(self._refresh_seq, rec.get("seq", -1))
            t = rec.get("type")
            if t in ("job-done", "job-failed", "job-quarantined"):
                job = rec.get("job")
                if job:
                    self._mark_terminal(job, t[len("job-"):])
            elif (
                t == "admit"
                and rec.get("spec_sha256") not in self._admitted_digests
            ):
                self._replay_admit(rec)

    def _prune_settled(self, pending: "list[Batch]") -> None:
        """Drop pending batches whose jobs a fleet peer already finished
        (absorbed via _refresh_journal) — claiming one would re-run
        settled work."""
        for b in list(pending):
            if b.jobs and all(j.name in self._terminal for j in b.jobs):
                pending.remove(b)
                b.status = "done"

    # --- scheduling seams (SweepService overrides) -----------------------

    def _poll(self, pending: "list[Batch]") -> None:
        self._refresh_journal(pending)
        self._prune_settled(pending)
        self._roll_window()
        self._scan_spool(pending)

    def _blocked_on_claims(self, pending: "list[Batch]") -> bool:
        """True when some arrived pending batch is unrunnable ONLY
        because a live peer's lease covers it — drain mode must keep
        waiting (the peer may die and its lease fall to us), while a
        queue blocked purely by quota-class budgets may exit (parked
        work is durable in the journal; a later daemon resumes it)."""
        now = time.time()
        for b in pending:
            if b.arrival_ns > self.clock_ns:
                continue
            cur = self._read_claim(self._claim_path(b))
            if (
                cur is not None
                and cur.get("owner") != self.daemon_id
                and float(cur.get("expires", 0)) > now
            ):
                return True
        return False

    def _idle(self, pending: "list[Batch]") -> bool:
        self._maybe_compact_journal()
        if self._stop:
            return False
        if self.drain_mode and not self._blocked_on_claims(pending):
            return False
        now = time.monotonic()
        if now - self._last_prom_wall >= self.prom_interval_s:
            self._last_prom_wall = now
            self._write_prom(pending)
        time.sleep(self.poll_interval_s)
        return not self._stop

    def _stopping(self) -> bool:
        return self._stop

    def _select(self, ready: "list[Batch]") -> Batch:
        """Strict priority first; weighted fair-share within the
        priority level — the tenant with the least weighted sim-time
        served runs next (deficit round-robin over the virtual clock),
        so a flood from one tenant cannot starve another's jobs of
        equal priority, and can never delay higher-priority work."""
        top = max(b.priority for b in ready)
        cands = [b for b in ready if b.priority == top]
        return min(
            cands,
            key=lambda b: (
                self.tenant_service.get(b.tenant or "", 0.0),
                b.arrival_ns,
                b.index,
            ),
        )

    def _account(self, batch: Batch, delta_ns: int) -> None:
        if batch.tenant and delta_ns > 0:
            w = max(self.weights.get(batch.tenant, 1.0), 1e-9)
            self.tenant_service[batch.tenant] = (
                self.tenant_service.get(batch.tenant, 0.0) + delta_ns / w
            )

    # --- quota classes (device-seconds budgets, enforced) ----------------

    def _roll_window(self) -> None:
        """Advance the quota refill window: once quota_window_s of wall
        passes, every tenant's spend-base snaps to its current ledger
        position — the budget refills without the ledger resetting."""
        now = time.monotonic()
        if now - self._window_start < self.quota_window_s:
            return
        periods = int((now - self._window_start) // self.quota_window_s)
        self._window_start += periods * self.quota_window_s
        self._accrue_device_seconds(rearm=True)
        self._window_base = dict(self.tenant_device_seconds)
        self._parked_note.clear()
        if self.quota_classes:
            slog("info", self.clock_ns, "daemon",
                 "quota window rolled: every tenant's device-seconds "
                 "budget refilled")

    def _budget_remaining(self, tenant: str) -> "float | None":
        """Device-seconds left in the tenant's current window, or None
        when the tenant has no quota class (unmetered)."""
        qc = self.quota_classes.get(tenant)
        if qc is None or qc.get("device_seconds") is None:
            return None
        spent = self.tenant_device_seconds.get(
            tenant, 0.0
        ) - self._window_base.get(tenant, 0.0)
        return qc["device_seconds"] - spent

    def _retry_after_s(self) -> float:
        """Seconds until the ledger's next refill window — the
        Retry-After of a quota-class refusal."""
        return round(
            max(
                0.0,
                self.quota_window_s
                - (time.monotonic() - self._window_start),
            ),
            3,
        )

    # --- fleet claims (journal-safe batch ownership) ---------------------

    def _claim_path(self, batch: Batch) -> str:
        key = batch.dir_key or f"b{batch.index:03d}"
        return os.path.join(self._sub("claims"), f"claim-{key}.json")

    def _read_claim(self, path: str) -> "dict | None":
        """The claim file's record, or None when absent/unreadable. A
        torn or corrupt claim reads as None — claimable, which at worst
        costs a redundant-but-idempotent re-run, never a lost batch."""
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        return doc if isinstance(doc, dict) else None

    def _claim_doc(self, batch: Batch) -> dict:
        return {
            "owner": self.daemon_id,
            "expires": round(time.time() + self.lease_s, 3),
            "key": batch.dir_key or f"b{batch.index:03d}",
            "jobs": [j.name for j in batch.jobs],
        }

    def _claim(self, batch: Batch) -> bool:
        """Take the batch's lease before dispatch. Exactly one daemon
        wins: a fresh claim commits with O_CREAT|O_EXCL, a dead peer's
        expired claim is stolen by atomic rename (one stealer wins the
        rename; everyone else sees ENOENT and retries the EXCL create).
        After winning, the journal is re-read: if a peer finished these
        jobs while we raced, the lease is dropped and the batch prunes
        instead of re-running settled work."""
        path = self._claim_path(batch)
        cur = self._read_claim(path)
        now = time.time()
        if cur is not None:
            owner = cur.get("owner")
            if owner != self.daemon_id and float(cur.get("expires", 0)) > now:
                return False  # a live peer owns it
            # expired (or our own stale) claim: steal by rename — the
            # atomic winner-take-all step of the reclaim protocol
            steal = f"{path}.steal.{os.getpid()}"
            try:
                os.rename(path, steal)
            except OSError:
                return False  # a peer won the steal race this cycle
            try:
                os.remove(steal)
            except OSError:
                pass
            if owner != self.daemon_id:
                self.claims_stolen += 1
                self.journal.append(
                    "claim-steal", key=cur.get("key"),
                    from_owner=owner, owner=self.daemon_id,
                    jobs=[j.name for j in batch.jobs],
                )
                slog("warning", self.clock_ns, "daemon",
                     f"reclaimed expired lease on {cur.get('key')} from "
                     f"{owner} — resuming from its newest checkpoint")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False  # a peer committed between our read and create
        except OSError:
            return False
        with os.fdopen(fd, "w") as f:
            json.dump(self._claim_doc(batch), f)
        self.leases_held += 1
        # the post-claim journal check: a peer may have FINISHED these
        # jobs between our runnability check and the lease commit
        self._refresh_journal(self.pending)
        if batch.jobs and all(j.name in self._terminal for j in batch.jobs):
            self._release_claim(batch)
            return False  # _prune_settled drops it next cycle
        # a batch inherited from a peer (crash, expiry): resume from the
        # newest checkpoint valid for this exact batch config
        self._refresh_resume(batch)
        return True

    def _release_claim(self, batch: Batch) -> None:
        path = self._claim_path(batch)
        cur = self._read_claim(path)
        if cur is not None and cur.get("owner") == self.daemon_id:
            try:
                os.remove(path)
            except OSError:
                pass
        self.leases_held = max(0, self.leases_held - 1)

    def _renew_lease(self, batch: Batch) -> None:
        """Chunk-tick lease renewal, throttled to lease_s/4 of wall. A
        claim that no longer names us (stolen after an expiry we slept
        through, or the `lease-steal` chaos fault) flips _lease_lost:
        the batch parks at the next chunk boundary and the thief — real
        or injected — owns the work."""
        from shadow_tpu_torch.runtime import chaos

        now = time.time()
        if now - self._lease_renew_wall < self.lease_s / 4:
            return
        self._lease_renew_wall = now
        path = self._claim_path(batch)
        if chaos.fire("lease-steal", at=self._renew_ord) is not None:
            thief = {
                **self._claim_doc(batch),
                "owner": "chaos-thief",
                "expires": round(now + self.lease_s, 3),
            }
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(thief, f)
            os.replace(tmp, path)
            slog("warning", self.clock_ns, "chaos",
                 f"injected fault: lease-steal on {thief['key']} — the "
                 "claim now names a foreign owner")
        self._renew_ord += 1
        cur = self._read_claim(path)
        if cur is None or cur.get("owner") != self.daemon_id:
            self._lease_lost = True
            return
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(self._claim_doc(batch), f)
            os.replace(tmp, path)
        except OSError:
            pass  # renewal retries next tick; expiry is the backstop

    def _refresh_resume(self, batch: Batch) -> None:
        """Point batch.resume_ckpt at the newest valid checkpoint for
        this exact batch config — the claim-steal resume step (the dead
        owner checkpointed right up to its last chunk; our own replay
        snapshot may be staler or absent)."""
        from shadow_tpu_torch.runtime.checkpoint import (
            CheckpointManager,
            peek_checkpoint_meta,
        )

        ckpt_dir = os.path.join(self._batch_dir(batch), "ckpts")
        path = CheckpointManager.latest_path(ckpt_dir)
        if path is not None:
            try:
                meta = peek_checkpoint_meta(path)
                if meta.get("fingerprint") != config_fingerprint(
                    self._batch_config(batch)
                ):
                    path = None
            except Exception:  # noqa: BLE001 — unusable = scratch
                path = None
        if path is not None:
            batch.resume_ckpt = path

    def _runnable(self, batch: Batch) -> bool:
        """Arrived batches filter out when their tenant's quota-class
        budget is exhausted (parked until the window refills) or a live
        fleet peer's lease covers them."""
        tenant = batch.tenant or self.default_tenant
        rem = self._budget_remaining(tenant)
        if rem is not None and rem <= 0:
            return False
        cur = self._read_claim(self._claim_path(batch))
        if (
            cur is not None
            and cur.get("owner") != self.daemon_id
            and float(cur.get("expires", 0)) > time.time()
        ):
            return False
        return True

    def _should_park(self, batch: Batch) -> bool:
        """Chunk-boundary park triggers: the lease was lost to a thief,
        or the tenant's budget ran dry mid-batch. Either way the batch
        checkpoints and re-queues via the preemption guard — parked,
        never lost."""
        tenant = batch.tenant or self.default_tenant
        reason = None
        if self._lease_lost:
            reason = "lease-lost"
        else:
            rem = self._budget_remaining(tenant)
            if rem is not None and rem <= 0:
                reason = "quota-class"
        if reason is None:
            return False
        key = batch.dir_key or f"b{batch.index:03d}"
        if key not in self._parked_note:
            # journal the park once per batch-run (the guard re-checks
            # every tick until the checkpoint boundary lands)
            self._parked_note.add(key)
            extra = (
                {"retry_after_s": self._retry_after_s()}
                if reason == "quota-class" else {}
            )
            self.journal.append(
                "park", key=key, tenant=tenant, reason=reason,
                jobs=[j.name for j in batch.jobs], **extra,
            )
            slog("warning", self.clock_ns, "daemon",
                 f"parking batch {key} ({reason}): checkpoint at the "
                 "next chunk boundary, then re-queue")
        return True

    def _run_batch(self, batch: Batch, pending: "list[Batch]") -> None:
        self._lease_lost = False
        self._lease_renew_wall = float("-inf")
        try:
            super()._run_batch(batch, pending)
        finally:
            # release AFTER terminal records are journaled (they land in
            # _write_batch_outputs -> _on_job_terminal before this
            # frame unwinds), so a peer never sees an unclaimed batch
            # with non-terminal jobs it could double-run. A lost lease
            # is not ours to release — the thief owns the claim file.
            if self._lease_lost:
                self.leases_held = max(0, self.leases_held - 1)
            else:
                self._release_claim(batch)

    def _ckpt_interval_ns(self, cfgo: ConfigOptions) -> int:
        # periodic checkpoints bound the work a SIGKILL can cost a
        # running batch (the config's cadence; preemption/shutdown still
        # write verified finals through the same manager)
        return cfgo.general.checkpoint_interval_ns

    def _on_batch_start(self, batch: Batch, depth: int) -> None:
        from shadow_tpu_torch.runtime import chaos

        grid = self._batch_grid(batch)
        self.journal.append(
            "batch-start", key=batch.dir_key or f"b{batch.index:03d}",
            jobs=[j.name for j in batch.jobs], tenant=batch.tenant,
            resume=batch.resume_ckpt, queue_depth=depth,
            # the grid this dispatch runs on: with the resume records'
            # `mesh` entries, the journal says which grid wrote each
            # checkpoint and which grid each restart resumed it on
            **({"mesh": grid} if grid else {}),
        )
        # device-seconds accounting anchor (accounting only, no
        # enforcement): chunk ticks accumulate wall x devices from here,
        # and the tail past the last tick flushes at the job-terminal
        # seam (or here, for a previous batch that split/failed without
        # reaching one)
        self._flush_device_seconds()
        self._anchor_tenant = batch.tenant or self.default_tenant
        self._anchor_devices = self._batch_devices(batch)
        self._batch_wall_anchor = time.monotonic()
        if chaos.fire("daemon-kill", at=self._batch_ord,
                      tags=("batch-start",)) is not None:
            self._kill_self(f"batch-start {self._batch_ord}")
        self._batch_ord += 1

    def _on_chunk_tick(self, batch: Batch, pending: "list[Batch]") -> None:
        from shadow_tpu_torch.runtime import chaos

        if chaos.fire("daemon-kill", at=self._chunk_ticks,
                      tags=("chunk",)) is not None:
            self._kill_self(f"chunk {self._chunk_ticks}")
        self._chunk_ticks += 1
        now = time.monotonic()
        # per-tenant device-seconds at chunk cadence (so a SIGKILL
        # loses at most one chunk's worth of accounting) — also the
        # enforcement read: _should_park sees a live ledger every tick
        self._accrue_device_seconds(rearm=True)
        self._roll_window()
        self._renew_lease(batch)
        if now - self._last_poll_wall >= self.poll_interval_s:
            self._last_poll_wall = now
            # live arrivals mid-batch: a higher-priority admission here
            # arms the preemption guard at the next chunk boundary —
            # and fleet peers' journal records absorb at the same cadence
            self._refresh_journal(pending)
            self._scan_spool(pending)
        if now - self._last_prom_wall >= self.prom_interval_s:
            # the satellite fix: gauges advance on a WALL cadence while
            # a batch runs, not only between scheduling decisions
            self._last_prom_wall = now
            self._write_prom(pending)

    def _accrue_device_seconds(self, rearm: bool) -> None:
        """ONE definition of the device-seconds accounting step: wall
        since the anchor times the devices the batch's grid occupies,
        credited to its tenant. `rearm` keeps the anchor running (the
        chunk-tick cadence); False disarms it (the flush seams)."""
        if self._batch_wall_anchor is None:
            return
        now = time.monotonic()
        t = self._anchor_tenant
        self.tenant_device_seconds[t] = (
            self.tenant_device_seconds.get(t, 0.0)
            + (now - self._batch_wall_anchor) * self._anchor_devices
        )
        self._batch_wall_anchor = now if rearm else None

    def _batch_devices(self, batch: Batch) -> int:
        """Logical devices the batch's grid occupies (1 on the
        single-device ensemble plane), the device-seconds multiplier:
        the requested grid (a degradation mid-batch over-counts, the
        conservative direction)."""
        grid = self._batch_grid(batch)
        if grid is None:
            return 1
        rows, shards = (int(x) for x in grid.split("x"))
        return rows * shards

    def _flush_device_seconds(self) -> None:
        """Account the tail between the last chunk tick and now against
        the anchored batch, then disarm the anchor — called at the
        job-terminal and next-batch-start seams so the final partial
        chunk plus the output epilogue of every batch (and a batch that
        failed before its first tick) is not dropped."""
        self._accrue_device_seconds(rearm=False)

    def _on_job_terminal(self, name: str, record: dict) -> None:
        self._flush_device_seconds()
        status = record.get("status")
        self._mark_terminal(name, status)
        entry = {
            "job": name,
            "tenant": self._job_tenant.get(name),
            "batch": record.get("batch"),
        }
        if record.get("failure"):
            entry["failure"] = record["failure"]
        if record.get("stats"):
            entry["events"] = record["stats"].get("events_handled")
        self.journal.append(_TERMINAL_TYPES.get(status, "job-done"), **entry)
        # terminal sentinel to event-stream subscribers: the stream ends
        # with the job's outcome (runtime/httpapi.py)
        if self._progress_subs:
            with self._subs_lock:
                for q in list(self._progress_subs.get(name, ())):
                    try:
                        q.put_nowait({"job": name, "terminal": status})
                    except Exception:  # noqa: BLE001
                        pass
        self._maybe_prune(record)
        self._maybe_compact_journal()

    def _maybe_compact_journal(self) -> None:
        """Compact once the journal's record-file count crosses the
        cadence — checked at terminal-job and idle seams, so a
        months-long spool's journal directory stays bounded at
        ~journal_compact_every files + two snapshots."""
        if (
            self.journal_compact_every > 0
            and self.journal.tail_files >= self.journal_compact_every
            and self.journal.tail_files != self.journal._compact_stuck_at
        ):
            try:
                self.journal.compact()
            except OSError as e:  # compaction is maintenance, never fatal
                slog("warning", 0, "daemon",
                     f"journal compaction failed ({e}); retrying at the "
                     "next cadence point")

    def _maybe_prune(self, record: dict) -> None:
        """Checkpoint-dir retention: a finished batch's checkpoints are
        dead weight — drop them the moment its last job lands, and
        prune leftover (crashed/preempted) batch dirs beyond the newest
        `keep_batch_dirs`, never touching a pending batch's."""
        import shutil

        idx = record.get("batch")
        if isinstance(idx, int) and 0 <= idx < len(self.batches):
            batch = self.batches[idx]
            if all(j.name in self._terminal for j in batch.jobs):
                shutil.rmtree(
                    os.path.join(self._batch_dir(batch), "ckpts"),
                    ignore_errors=True,
                )
        from shadow_tpu_torch.runtime.checkpoint import CheckpointManager

        protect = {self._batch_dir(b) for b in self.pending}
        CheckpointManager.prune_batch_dirs(
            self._sub("batches"), self.keep_batch_dirs, protect=protect
        )

    # --- HTTP front-door support (runtime/httpapi.py) --------------------

    def _on_progress(self, name: str, point: dict) -> None:
        if not self._progress_subs:
            return
        with self._subs_lock:
            for q in list(self._progress_subs.get(name, ())):
                try:
                    q.put_nowait({"job": name, **point})
                except Exception:  # noqa: BLE001 — a full/closed
                    pass  # subscriber queue never stalls the drain loop

    def subscribe_progress(self, name: str):
        """A bounded queue of progress points for one job — the HTTP
        event stream's feed, filled by _on_progress at chunk cadence
        and closed by the terminal sentinel _on_job_terminal posts."""
        import queue as _queue

        q = _queue.Queue(maxsize=256)
        with self._subs_lock:
            self._progress_subs.setdefault(name, []).append(q)
        return q

    def unsubscribe_progress(self, name: str, q) -> None:
        with self._subs_lock:
            subs = self._progress_subs.get(name, [])
            if q in subs:
                subs.remove(q)
            if not subs:
                self._progress_subs.pop(name, None)

    def job_status(self, job_id: str) -> "dict | None":
        """One job's status document (GET /v1/jobs/{id}): admitted ->
        queued/running off the live progress mirror, terminal off the
        journal-backed terminal map. None = never admitted (404)."""
        tenant = self._job_tenant.get(job_id)
        if tenant is None:
            return None
        terminal = self._terminal.get(job_id)
        progress = self.job_progress.get(job_id)
        if terminal is not None:
            status = terminal
        elif progress and (progress.get("now_ns") or progress.get("events")):
            status = "running"
        else:
            status = "queued"
        doc = {"job": job_id, "tenant": tenant, "status": status}
        if progress:
            doc["progress"] = dict(progress)
        rec = self.job_records.get(job_id)
        if rec:
            for k in ("stats", "failure", "error", "wall_seconds"):
                if rec.get(k) is not None:
                    doc[k] = rec[k]
        return doc

    def job_results_path(self, job_id: str) -> str:
        return os.path.join(self.spool_dir, "jobs", job_id,
                            "sim-stats.json")

    def http_refusal(self, tenant, reason, detail, **extra) -> dict:
        """A front-door refusal that never touched the spool: journaled
        with the same structured record the .reason.json reply files
        carry, so an HTTP 4xx is as auditable as a spool rejection."""
        rec = self.journal.append(
            "reject", via="http", tenant=tenant, reason=reason,
            detail=str(detail)[:400], **extra,
        )
        tn = tenant or "?"
        self._rejected[tn] = self._rejected.get(tn, 0) + 1
        rec2 = getattr(self, "recorder", None)
        if rec2 is not None:
            rec2.event("reject", tenant=tenant, reason=reason, via="http")
        return rec

    def spool_body(self, text: str, label: str) -> str:
        """Atomically drop an HTTP-submitted spec into incoming/ — the
        identical write-then-rename protocol submit_spec uses, stamped
        with the receive-time nanosecond prefix, so HTTP admissions ride
        the journal-crash-safe path (and its latency percentiles)
        unchanged."""
        inc = self._sub("incoming")
        dest = os.path.join(
            inc, f"{time.time_ns():020d}-http-{label}.yaml"
        )
        tmp = os.path.join(
            inc, f".{os.path.basename(dest)}.tmp.{os.getpid()}"
        )
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, dest)
        return dest

    def render_metrics(self) -> str:
        """The prom textfile as a string (GET /v1/metrics): the same
        gauge set _write_prom persists, rendered without touching
        disk."""
        return self.recorder.render_prom(
            extra_gauges=self._prom_gauges(self.pending)
        )

    # --- telemetry -------------------------------------------------------

    def _prom_gauges(self, pending: "list[Batch]") -> dict:
        g = super()._prom_gauges(pending)
        g["shadow_tpu_daemon_uptime_seconds"] = round(
            time.monotonic() - self._t0, 3
        )
        g["shadow_tpu_daemon_jobs_admitted_total"] = len(self._job_tenant)
        g["shadow_tpu_daemon_jobs_rejected_total"] = sum(
            self._rejected.values()
        )
        g["shadow_tpu_daemon_journal_records_total"] = self.journal.count
        for t in sorted(self._outstanding_t):
            g[f'shadow_tpu_tenant_queue_depth{{tenant="{t}"}}'] = (
                self._outstanding(t)
            )
        # device-seconds served per tenant (the quota-class ledger)
        for t in sorted(self.tenant_device_seconds):
            g[f'shadow_tpu_tenant_device_seconds{{tenant="{t}"}}'] = round(
                self.tenant_device_seconds[t], 3
            )
        # budget left this window, per quota-classed tenant (clamped at
        # 0: "how much runway" — overdraft detail lives in the ledger)
        for t in sorted(self.quota_classes):
            rem = self._budget_remaining(t)
            if rem is not None:
                g[
                    f'shadow_tpu_tenant_budget_remaining{{tenant="{t}"}}'
                ] = round(max(rem, 0.0), 3)
        g[
            f'shadow_tpu_daemon_leases_held{{daemon="{self.daemon_id}"}}'
        ] = self.leases_held
        if self.front_door is not None:
            g.update(self.front_door.gauges())
        stats = self.cache.stats()
        if "persistent" in stats:
            p = stats["persistent"]
            g["shadow_tpu_compile_cache_disk_hits_total"] = p["disk_hits"]
            g["shadow_tpu_compile_cache_disk_stores_total"] = p["disk_stores"]
        return g

    def _write_prom(self, pending: "list[Batch]") -> None:
        super()._write_prom(pending)
        # the manifest doubles as the daemon's rolling status document:
        # refreshed at prom cadence so a SIGKILL leaves a recent one
        self._manifest_doc = None
        self._write_manifest(rolling=True)

    def _tenant_table(self) -> dict:
        out: "dict[str, dict]" = {}
        for t in sorted(
            set(self._job_tenant.values())
            | set(self._rejected)
            | set(self.quotas)
        ):
            jobs = [n for n, jt in self._job_tenant.items() if jt == t]
            out[t] = {
                "admitted": len(jobs),
                "outstanding": self._outstanding(t),
                "done": sum(
                    1 for n in jobs if self._terminal.get(n) == "done"
                ),
                "failed": sum(
                    1 for n in jobs if self._terminal.get(n) == "failed"
                ),
                "quarantined": sum(
                    1 for n in jobs if self._terminal.get(n) == "quarantined"
                ),
                "rejected_specs": self._rejected.get(t, 0),
                "quota": self.quotas.get(t, self.default_quota),
                "weight": self.weights.get(t, 1.0),
                **(
                    {
                        "quota_class": self.quota_classes[t],
                        "budget_remaining_s": round(
                            max(self._budget_remaining(t) or 0.0, 0.0), 3
                        ),
                    }
                    if t in self.quota_classes else {}
                ),
                "service_sim_s": round(
                    self.tenant_service.get(t, 0.0) / 1e9, 4
                ),
                # wall x devices actually served (the accounting half of
                # device-time quotas; enforcement is future work)
                "device_seconds": round(
                    self.tenant_device_seconds.get(t, 0.0), 3
                ),
            }
        return out

    def _daemon_manifest(self, wall: float) -> dict:
        m = self._manifest(wall)
        done_this_run = m["jobs_done"]
        m["daemon"] = {
            "spool": self.spool_dir,
            "id": self.daemon_id,
            "drain": self.drain_mode,
            "uptime_s": round(time.monotonic() - self._t0, 3),
            "leases_held": self.leases_held,
            "claims_stolen": self.claims_stolen,
            # arrival -> journaled-admit wall per job this run, nearest-
            # rank percentiles (docs/service.md "HTTP front door")
            "admit_latency": {
                "count": len(self._admit_latencies),
                **_percentiles(self._admit_latencies),
            },
            **(
                {"http": self.front_door.describe()}
                if self.front_door is not None else {}
            ),
            "jobs_per_hour": (
                round(done_this_run / wall * 3600, 1) if wall > 0 else None
            ),
            "outstanding_jobs": self._outstanding(),
            "jobs_admitted_total": len(self._job_tenant),
            "jobs_done_total": sum(
                1 for s in self._terminal.values() if s == "done"
            ),
            "journal": {
                "records": self.journal.count,
                "tail_files": self.journal.tail_files,
                "compactions": self.journal.compactions,
                "corrupt_skipped": self.journal.corrupt_skipped,
            },
            # jobs failed during THIS run's journal replay (spec no
            # longer validates): zero-lost accounting demands they count
            # against the run's exit code, even though they never
            # entered the live queue
            "replay_failed_jobs": self.replay_failed,
            "tenants": self._tenant_table(),
            **({"resume": self.resume_report} if self.resume_report else {}),
        }
        return m

    def _write_manifest(self, rolling: bool = False) -> None:
        path = os.path.join(self.spool_dir, "daemon-manifest.json")
        try:
            doc = self._manifest_doc
            if doc is None:
                doc = self._daemon_manifest(
                    max(time.monotonic() - self._t0, 1e-9)
                )
                if rolling:
                    doc["daemon"]["rolling"] = True
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=2, default=str)
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError):
            pass  # status writing must never take the daemon down


def submit_spec(spool_dir: str, spec_path: str,
                tenant: "str | None" = None) -> str:
    """`shadow-tpu submit`: atomically drop a job spec into a spool's
    incoming/ directory (write to a dotted tmp name the scanner
    ignores, then rename — the daemon can never read a torn file).
    `tenant` overrides/sets job.tenant. Returns the spooled path."""
    with open(spec_path) as f:
        raw = yaml.safe_load(f.read())
    if not isinstance(raw, dict) or "job" not in raw:
        raise ValueError("spec must be a mapping with a 'job' section")
    if tenant is not None:
        raw = dict(raw)
        raw["job"] = dict(raw["job"])
        raw["job"]["tenant"] = tenant
    inc = os.path.join(spool_dir, "incoming")
    os.makedirs(inc, exist_ok=True)
    name = os.path.basename(spec_path)
    if not name.endswith((".yaml", ".yml")):
        name += ".yaml"
    # zero-padded nanosecond prefix: the scanner admits in sorted-name
    # order, so submission order is admission order (and two rapid
    # submissions of the same filename can never collide)
    dest = os.path.join(inc, f"{time.time_ns():020d}-{name}")
    tmp = os.path.join(inc, f".{os.path.basename(dest)}.tmp.{os.getpid()}")
    with open(tmp, "w") as f:
        yaml.safe_dump(raw, f, sort_keys=False)
    os.replace(tmp, dest)
    return dest


def spec_job_ids(spec_path: str, tenant: "str | None" = None):
    """The canonical job ids a spec will admit under — tenant, entry
    name, and seed expansion ONLY, no config validation (a bad scenario
    must become the daemon's journaled rejection, not a submit-side
    crash). Returns (tenant, entry, ids); `shadow-tpu submit` prints
    the ids and --wait polls them."""
    with open(spec_path) as f:
        raw = yaml.safe_load(f.read())
    if not isinstance(raw, dict) or not isinstance(raw.get("job"), dict):
        raise ValueError("spec must be a mapping with a 'job' section")
    j = dict(raw["job"])
    t = str(tenant if tenant is not None else j.get("tenant", "default"))
    ename = str(j.get("name", ""))
    for label, val in (("tenant", t), ("name", ename)):
        if not _NAME_RE.match(val or ""):
            raise ValueError(
                f"job.{label} {val!r} must match {_NAME_RE.pattern}"
            )
    seeds = _expand_seeds(
        ename,
        {k: j[k] for k in ("seeds", "seed_range") if k in j},
    )
    return t, ename, [f"{t}.{ename}-s{s}" for s in seeds]


def journal_terminal_map(spool_dir: str) -> "dict[str, str]":
    """job -> terminal status from a spool's journal, snapshot + tail —
    the polling read `shadow-tpu submit --wait` uses. Read-only and
    safe against live daemons: records commit atomically and corrupt
    ones are skipped."""
    j = Journal(os.path.join(spool_dir, "journal"))
    term: "dict[str, str]" = {}
    recs = j.replay()
    if j.snapshot:
        term.update(j.snapshot.get("terminal", {}))
    for r in recs:
        t = r.get("type")
        if t in ("job-done", "job-failed", "job-quarantined"):
            term[r.get("job")] = t[len("job-"):]
    return term
