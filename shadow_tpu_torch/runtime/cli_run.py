"""`run`, `mem`, `sweep`, `serve` and `submit` implementations (port of
shadow_tpu/runtime/cli_run.py, on one device: `cuda` unless the caller
passes `device="cpu"`). User mistakes surface as CliUserError and print
as one-line errors."""

from __future__ import annotations

import json
import os
import sys

import yaml

from shadow_tpu_torch.config import load_config_file
from shadow_tpu_torch.engine.round import (
    CapacityError,
    EngineCompileError,
    RunInterrupted,
    WatchdogExpired,
)
from shadow_tpu_torch.runtime.checkpoint import CheckpointError
from shadow_tpu_torch.runtime.manager import Manager
from shadow_tpu_torch.utils.shadow_log import set_level


class CliUserError(Exception):
    pass


def run_from_config(path: str, device: str = "cuda", show_config: bool = False,
                    replicas: "int | None" = None,
                    replica_seed_stride: "int | None" = None,
                    checkpoint_dir: "str | None" = None,
                    checkpoint_interval: "str | None" = None,
                    resume: bool = False, no_recover: bool = False,
                    tracker: bool = False, trace_file: "str | None" = None,
                    metrics_file: "str | None" = None, metrics_prom: "str | None" = None,
                    xprof_dir: "str | None" = None, xprof_chunks: "str | None" = None,
                    autotune: "float | None" = None, no_autotune: bool = False,
                    chunk_watchdog: "float | None" = None, chaos_seed: "int | None" = None,
                    chaos_faults: "list[str] | None" = None,
                    mesh: "str | None" = None) -> int:
    try:
        config = load_config_file(path)
    except (ValueError, OSError, yaml.YAMLError) as e:
        raise CliUserError(f"invalid config: {e}") from e
    # CLI flags override the config's general/experimental sections
    if tracker:
        config.general.tracker = True
    if trace_file:
        config.general.trace_file = trace_file
    if checkpoint_dir:
        config.general.checkpoint_dir = checkpoint_dir
    if checkpoint_interval:
        from shadow_tpu_torch.simtime import parse_time_ns

        try:
            config.general.checkpoint_interval_ns = parse_time_ns(checkpoint_interval)
        except ValueError as e:
            raise CliUserError(f"invalid --checkpoint-interval: {e}") from e
    if resume:
        config.general.resume = True
    if no_recover:
        config.experimental.recover = False
    if autotune is not None:
        # bare --autotune keeps the config's budget (const = -1.0)
        config.experimental.autotune = True
        if autotune >= 0:
            config.experimental.autotune_budget_s = autotune
    if no_autotune:
        config.experimental.autotune = False
    if replicas is not None:
        if replicas < 1:
            raise CliUserError("--replicas must be >= 1")
        config.general.replicas = replicas
    if replica_seed_stride is not None:
        if replica_seed_stride < 1:
            raise CliUserError("--replica-seed-stride must be >= 1")
        config.general.replica_seed_stride = replica_seed_stride
    if mesh is not None:
        from shadow_tpu_torch.config.options import canonical_mesh

        try:
            config.general.mesh = canonical_mesh(mesh)
        except ValueError as e:
            raise CliUserError(f"invalid --mesh: {e}") from e
    if chunk_watchdog is not None:
        if chunk_watchdog < 0:
            raise CliUserError("--chunk-watchdog must be >= 0")
        config.experimental.chunk_watchdog_s = chunk_watchdog
    if metrics_file:
        config.general.metrics_file = metrics_file
    if metrics_prom:
        config.general.metrics_prom = metrics_prom
    if xprof_dir:
        config.experimental.xprof_dir = xprof_dir
    if xprof_chunks:
        parts = xprof_chunks.split(":")
        if (
            len(parts) != 2
            or not all(p.isdigit() for p in parts)
            or int(parts[1]) <= int(parts[0])
        ):
            raise CliUserError(
                f"invalid --xprof-chunks {xprof_chunks!r}: expected "
                "'START:END' with 0 <= START < END"
            )
        config.experimental.xprof_chunks = xprof_chunks
    if chaos_seed is not None:
        config.chaos.seed = chaos_seed
    for arg in chaos_faults or []:
        from shadow_tpu_torch.runtime.chaos import parse_fault_arg

        try:
            config.chaos.faults.append(parse_fault_arg(arg))
        except ValueError as e:
            raise CliUserError(f"invalid --chaos-fault {arg!r}: {e}") from e
    set_level(config.general.log_level)
    if show_config:
        print(json.dumps(config.to_dict(), indent=2, default=str))
        return 0
    try:
        manager = Manager(config, device=device)  # construction = world validation
    except (ValueError, OSError) as e:
        raise CliUserError(str(e)) from e
    try:
        results = manager.run()
    except RunInterrupted as e:
        # not a user error: the run stopped on request with a final
        # checkpoint written; 130 is the conventional SIGINT exit status
        print(f"shadow-tpu-torch: {e}; resume with --resume", file=sys.stderr)
        return 130
    except (CapacityError, WatchdogExpired, EngineCompileError, CheckpointError,
            ValueError) as e:
        # the degradation ladder's terminal rungs (recovery budget
        # exhausted, watchdog past its retries, the plain engine failing
        # an injected compile fault too), checkpoint/resume validation
        # (fingerprint mismatch, missing checkpoint), config mistakes
        raise CliUserError(str(e)) from e
    if results.unexpected_final_states:
        return 1
    return 0 if results.packets_unroutable == 0 else 1


def priced_state(world, replicas: int = 1, device="meta"):
    """The state a run of `world` would hold, for pricing: built on
    `device` (`meta` by default: shapes and dtypes, no storage) by
    init_state, and for replicas > 1 stacked to the ensemble's [R, ...]
    shapes. Bootstrapping and per-replica keys change values, never
    shapes, so neither is run."""
    import torch

    from shadow_tpu_torch.engine.state import init_state
    from shadow_tpu_torch.utils.tree import tree_map

    dev = torch.device(device)
    st = init_state(world.ecfg, world.model.init(dev), tx_bytes_per_interval=world.tx_refill,
                    rx_bytes_per_interval=world.rx_refill, device=dev)
    if replicas > 1:
        st = tree_map(lambda x: x.expand((replicas,) + tuple(x.shape)).contiguous(), st)
    return st


def run_mem(path: str, hbm_gb: "float | None" = None, replicas: "int | None" = None,
            mesh: "str | None" = None, json_out: bool = False) -> int:
    """`mem`: price the config's device state without allocating it. The
    state is built on the `meta` device (priced_state), so a world of
    millions of hosts prices in moments; the table is exact for the
    tensors the run would allocate (runtime/memtrack.py)."""
    from shadow_tpu_torch.runtime import memtrack

    try:
        config = load_config_file(path)
    except (ValueError, OSError, yaml.YAMLError) as e:
        raise CliUserError(f"invalid config: {e}") from e
    if replicas is not None:
        if replicas < 1:
            raise CliUserError("--replicas must be >= 1")
        config.general.replicas = replicas
    if mesh is not None:
        from shadow_tpu_torch.config.options import canonical_mesh

        try:
            config.general.mesh = canonical_mesh(mesh)
        except ValueError as e:
            raise CliUserError(f"invalid --mesh: {e}") from e
    set_level(config.general.log_level)
    try:
        # the world is validated as a run validates it (a mesh against the
        # CPU's logical devices); nothing is placed on a device
        # (device="cpu" only names where tables would live)
        manager = Manager(config, device="cpu")
        world = manager.build_world()
    except (ValueError, OSError) as e:
        raise CliUserError(str(e)) from e
    # a mesh run holds init_mesh_state's stack: the ensemble's shapes for
    # the plan's replica count (the grid splits it, adding no bytes)
    plan = manager.mesh_plan
    replicas = plan.replicas if plan is not None else config.general.replicas
    report = memtrack.price_state(priced_state(world, replicas), world.ecfg)
    if json_out:
        print(json.dumps(report, indent=2))
    else:
        print(memtrack.render_report(report, hbm_gb=hbm_gb))
    return 0


def run_sweep(
    spec_path: str,
    output_dir: "str | None" = None,
    show_plan: bool = False,
    metrics_file: "str | None" = None,
    metrics_prom: "str | None" = None,
    device: str = "cuda",
) -> int:
    """`sweep` implementation: expand + pack + (optionally) execute a
    sweep spec, its batches on `device`. Exit 0 when every job
    completed cleanly — any job ending `failed` or `quarantined` makes
    the process exit non-zero, and a job that finished with unroutable
    packets counts against the exit code exactly as its standalone
    `shadow-tpu run` would."""
    from shadow_tpu_torch.config.sweep import load_sweep_file
    from shadow_tpu_torch.runtime.sweep import SweepService, render_report

    try:
        spec = load_sweep_file(spec_path, output_dir=output_dir)
    except (ValueError, OSError, yaml.YAMLError) as e:
        raise CliUserError(f"invalid sweep spec: {e}") from e
    try:
        service = SweepService(
            spec, metrics_file=metrics_file, metrics_prom=metrics_prom,
            device=device,
        )
    except ValueError as e:
        raise CliUserError(str(e)) from e
    if show_plan:
        print(json.dumps(service.plan(), indent=2))
        return 0
    try:
        manifest = service.run()
    except (ValueError, OSError) as e:
        raise CliUserError(str(e)) from e
    print(render_report(manifest))
    clean = (
        manifest["jobs_done"] == manifest["jobs_total"]
        and manifest["jobs_failed"] == 0
        and manifest["jobs_quarantined"] == 0
        and manifest["jobs_unroutable"] == 0
    )
    return 0 if clean else 1


def _parse_kv_list(args, cast, flag: str) -> dict:
    out = {}
    for item in args or []:
        key, sep, val = str(item).partition("=")
        if not sep or not key:
            raise CliUserError(f"invalid {flag} {item!r}: expected KEY=VALUE")
        try:
            out[key] = cast(val)
        except ValueError as e:
            raise CliUserError(f"invalid {flag} {item!r}: {e}") from e
    return out


def run_serve(
    spool: str,
    drain: bool = False,
    poll_interval: float = 2.0,
    prom_interval: float = 10.0,
    capacity: int = 8,
    retry_max: int = 1,
    max_queue: int = 256,
    default_quota: int = 64,
    quotas: "list[str] | None" = None,
    quota_classes: "list[str] | None" = None,
    quota_window: float = 3600.0,
    weights: "list[str] | None" = None,
    http: "str | None" = None,
    lease_s: float = 30.0,
    daemon_id: "str | None" = None,
    keep_batch_dirs: int = 8,
    cache_dir: "str | None" = None,
    no_cache_persist: bool = False,
    metrics_file: "str | None" = None,
    metrics_max_mb: float = 64.0,
    metrics_keep: int = 3,
    metrics_prom: "str | None" = None,
    chaos_seed: "int | None" = None,
    chaos_faults: "list[str] | None" = None,
    mesh: "str | None" = None,
    journal_compact_every: int = 512,
    device: str = "cuda",
) -> int:
    """`serve` implementation, batches on `device`. Exit 0 when the
    daemon shut down cleanly with no job left
    `failed`/`quarantined` this run; rejections alone do not fail the
    daemon (they are the submitter's structured signal)."""
    import contextlib

    from shadow_tpu_torch.runtime import chaos
    from shadow_tpu_torch.runtime.daemon import DaemonService, parse_quota_class

    if capacity < 1:
        raise CliUserError("--capacity must be >= 1")
    if retry_max < 0:
        raise CliUserError("--retry-max must be >= 0")
    if max_queue < 1 or default_quota < 1:
        raise CliUserError("--max-queue and --default-quota must be >= 1")
    if quota_window <= 0:
        raise CliUserError("--quota-window must be > 0")
    if lease_s <= 0:
        raise CliUserError("--lease-s must be > 0")
    qclasses = {}
    for arg in quota_classes or []:
        try:
            t, cls = parse_quota_class(arg)
        except ValueError as e:
            raise CliUserError(f"invalid --quota-class {arg!r}: {e}") from e
        qclasses[t] = cls
    if http is not None:
        from shadow_tpu_torch.runtime.httpapi import parse_http_addr

        try:
            parse_http_addr(http)
        except ValueError as e:
            raise CliUserError(str(e)) from e
    from shadow_tpu_torch.runtime.chaos import parse_fault_arg

    faults = []
    for arg in chaos_faults or []:
        try:
            faults.append(parse_fault_arg(arg))
        except ValueError as e:
            raise CliUserError(f"invalid --chaos-fault {arg!r}: {e}") from e
    if mesh is not None:
        from shadow_tpu_torch.config.options import canonical_mesh

        try:
            mesh = canonical_mesh(mesh)
        except ValueError as e:
            raise CliUserError(f"invalid --mesh: {e}") from e
    if journal_compact_every < 0:
        raise CliUserError("--journal-compact-every must be >= 0 (0 = off)")
    try:
        service = DaemonService(
            spool,
            capacity=capacity,
            retry_max=retry_max,
            default_quota=default_quota,
            quotas=_parse_kv_list(quotas, int, "--quota"),
            quota_classes=qclasses or None,
            quota_window_s=quota_window,
            weights=_parse_kv_list(weights, float, "--weight"),
            http=http,
            lease_s=lease_s,
            daemon_id=daemon_id,
            max_queue=max_queue,
            poll_interval_s=poll_interval,
            prom_interval_s=prom_interval,
            keep_batch_dirs=keep_batch_dirs,
            drain=drain,
            cache_dir=cache_dir,
            persist_cache=not no_cache_persist,
            metrics_file=metrics_file,
            metrics_max_mb=metrics_max_mb,
            metrics_keep=metrics_keep,
            metrics_prom=metrics_prom,
            mesh=mesh,
            journal_compact_every=journal_compact_every,
            device=device,
        )
    except (ValueError, OSError) as e:
        raise CliUserError(str(e)) from e
    plan = (
        chaos.FaultPlan(seed=chaos_seed or 0, faults=faults)
        if faults else None
    )
    ctx = chaos.installed(plan) if plan else contextlib.nullcontext()
    try:
        with ctx:
            manifest = service.run()
    except OSError as e:
        raise CliUserError(str(e)) from e
    d = manifest["daemon"]
    print(
        f"daemon on {d['spool']}: {manifest['jobs_done']} job(s) done this "
        f"run ({d['jobs_done_total']} total), "
        f"{manifest['jobs_failed']} failed, "
        f"{manifest['jobs_quarantined']} quarantined, "
        f"{d['outstanding_jobs']} outstanding, "
        f"{d['journal']['records']} journal record(s)"
        + (f", {d['jobs_per_hour']} jobs/hour" if d["jobs_per_hour"] else "")
        + (
            f", {d['replay_failed_jobs']} failed at journal replay"
            if d.get("replay_failed_jobs") else ""
        )
    )
    cache = manifest["compile_cache"]
    line = (
        f"compile cache: {cache['compiles']} compile(s), "
        f"{cache['hits']} hit(s) (rate {cache['hit_rate']:.2f})"
    )
    if "persistent" in cache:
        p = cache["persistent"]
        line += (
            f"; persistent: {p['disk_hits']} disk hit(s), "
            f"{p['disk_stores']} stored, {p['disk_skips']} skipped"
        )
    print(line)
    lat = d.get("admit_latency") or {}
    if lat.get("count"):
        print(
            f"admission latency over {lat['count']} admit(s): "
            f"p50 {lat['p50']}s, p90 {lat['p90']}s, p99 {lat['p99']}s"
        )
    clean = (
        manifest["jobs_failed"] == 0
        and manifest["jobs_quarantined"] == 0
        # jobs marked failed during journal replay never enter the live
        # queue's counters, but they are failures of this run
        and d.get("replay_failed_jobs", 0) == 0
    )
    return 0 if clean else 1


def run_submit(
    spool: str,
    spec: str,
    tenant: "str | None" = None,
    wait: bool = False,
    timeout: "float | None" = None,
    http: "str | None" = None,
    poll_s: float = 1.0,
) -> int:
    """`submit` implementation: atomic drop into the spool,
    printing the canonical job ids the daemon will admit under. With
    --wait, poll until every id is terminal — via the journal, or the
    HTTP status endpoint when --http URL is given (a submitter that can
    see the spool but scrapes a remote daemon). Exit 0 iff all jobs
    finished `done`; 1 on any failed/quarantined/rejected outcome; 2
    when --timeout expires first."""
    from shadow_tpu_torch.runtime.daemon import spec_job_ids, submit_spec

    try:
        _tn, _entry, ids = spec_job_ids(spec, tenant=tenant)
        dest = submit_spec(spool, spec, tenant=tenant)
    except (ValueError, OSError, yaml.YAMLError) as e:
        raise CliUserError(f"invalid spec: {e}") from e
    print(f"spooled {dest}")
    for jid in ids:
        print(f"job {jid}")
    if not wait:
        return 0
    return _wait_for_jobs(
        spool, os.path.basename(dest), ids,
        timeout=timeout, http=http, poll_s=poll_s,
    )


def _http_job_status(base_url: str, jid: str) -> "str | None":
    """One GET /v1/jobs/{id} poll: the job's status, or None while the
    daemon does not know the id yet (404) or is unreachable (it may
    still be starting — --timeout bounds the patience)."""
    import urllib.error
    import urllib.request

    url = f"{base_url.rstrip('/')}/v1/jobs/{jid}"
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return json.loads(resp.read()).get("status")
    except urllib.error.HTTPError as e:
        if e.code == 404:
            return None
        raise CliUserError(f"GET {url} failed: HTTP {e.code}") from e
    except (OSError, ValueError):
        return None


def _wait_for_jobs(
    spool: str,
    spooled_name: str,
    ids: "list[str]",
    timeout: "float | None" = None,
    http: "str | None" = None,
    poll_s: float = 1.0,
) -> int:
    import glob
    import time

    deadline = (
        time.monotonic() + timeout if timeout is not None else None
    )
    terminal: "dict[str, str]" = {}
    while True:
        if http:
            for jid in ids:
                if jid in terminal:
                    continue
                status = _http_job_status(http, jid)
                if status in ("done", "failed", "quarantined"):
                    terminal[jid] = status
        else:
            from shadow_tpu_torch.runtime.daemon import journal_terminal_map

            term = journal_terminal_map(spool)
            terminal = {jid: term[jid] for jid in ids if jid in term}
            # a rejected spec never admits, so its jobs never reach the
            # journal — the structured reply file is the terminal signal
            hits = glob.glob(os.path.join(
                spool, "rejected", f"*-{spooled_name}.reason.json"
            ))
            if hits and len(terminal) < len(ids):
                try:
                    with open(hits[0]) as f:
                        rec = json.load(f)
                    detail = f"{rec.get('reason')}: {rec.get('detail')}"
                except (OSError, ValueError):
                    detail = hits[0]
                print(f"rejected: {detail}", file=sys.stderr)
                return 1
        if len(terminal) == len(ids):
            break
        if deadline is not None and time.monotonic() >= deadline:
            missing = [jid for jid in ids if jid not in terminal]
            print(
                f"timeout: {len(missing)} of {len(ids)} job(s) not "
                f"terminal after {timeout}s "
                f"(first pending: {missing[0]})",
                file=sys.stderr,
            )
            return 2
        time.sleep(poll_s)
    for jid in ids:
        print(f"{jid}: {terminal[jid]}")
    return 0 if all(s == "done" for s in terminal.values()) else 1
