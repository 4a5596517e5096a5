"""`python -m shadow_tpu_torch run CONFIG` (port of shadow_tpu/cli.py:
the `run`, `sweep`, `serve`, `submit`, `mem`, `metrics` and
`shm-cleanup` subcommands). `run`, `sweep` and `serve` run on the GPU
unless `--device cpu` is given; `submit` drops a job spec into a
daemon's spool; `mem` prices a config's state without allocating it,
`metrics` renders a recorded metrics series, and `shm-cleanup` removes
the host kernel's shared-memory blocks that no live process maps."""

from __future__ import annotations

import argparse
import sys


def main(argv: "list[str] | None" = None) -> int:
    import shadow_tpu_torch

    parser = argparse.ArgumentParser(
        prog="shadow-tpu-torch",
        description="PDES network simulator (PyTorch/CUDA port of shadow-tpu)",
    )
    parser.add_argument(
        "--version", action="version", version=f"shadow_tpu_torch {shadow_tpu_torch.__version__}"
    )
    sub = parser.add_subparsers(dest="command")
    run_p = sub.add_parser("run", help="run a simulation from a YAML config")
    run_p.add_argument("config", help="path to shadow.yaml-style config")
    run_p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the simulation state lives (default: cuda)",
    )
    run_p.add_argument("--show-config", action="store_true", help="print resolved config and exit")
    run_p.add_argument(
        "--tracker", action="store_true",
        help="enable the device-side tracker plane: per-host heartbeat "
        "counters and a per-kind/per-class breakdown in sim-stats.json "
        "(general.tracker)",
    )
    run_p.add_argument(
        "--trace-file", metavar="PATH",
        help="write a Chrome-trace JSON of the dispatch pipeline "
        "(chrome://tracing / Perfetto loadable; general.trace_file)",
    )
    run_p.add_argument(
        "--metrics-file", metavar="PATH",
        help="stream per-chunk metrics samples as JSONL while the run "
        "is live (tailable; flushed at heartbeat cadence; no extra "
        "device syncs; general.metrics_file). Render later with "
        "`python -m shadow_tpu_torch metrics PATH`",
    )
    run_p.add_argument(
        "--metrics-prom", metavar="PATH",
        help="rewrite a Prometheus textfile snapshot of the run's "
        "gauges at heartbeat cadence (node-exporter textfile collector "
        "format; general.metrics_prom)",
    )
    run_p.add_argument(
        "--xprof-dir", metavar="DIR",
        help="capture a torch.profiler trace (host and CUDA activity) of "
        "the chunk dispatches in the --xprof-chunks window into DIR as a "
        "Chrome trace (experimental.xprof_dir; best-effort)",
    )
    run_p.add_argument(
        "--xprof-chunks", metavar="A:B",
        help="chunk index window [A, B) the --xprof-dir capture "
        "brackets (default 1:3; experimental.xprof_chunks)",
    )
    run_p.add_argument(
        "--replicas", type=int, metavar="N",
        help="run N independent seeded replicas of the scenario as one batch "
        "(scripted models, tpu scheduler); replica r is leaf-identical to a "
        "single run seeded seed + r*stride, and sim-stats.json gains "
        "per-replica and aggregate CI sections (general.replicas)",
    )
    run_p.add_argument(
        "--replica-seed-stride", type=int, metavar="K",
        help="spacing between consecutive replicas' derived seeds "
        "(default 1; general.replica_seed_stride)",
    )
    run_p.add_argument(
        "--mesh", metavar="RxS",
        help="lay the replica batch over a 2-D grid of logical devices: R "
        "replica rows x S host-shards (hosts block-sharded inside each row; "
        "replicas never communicate). The replica count is --replicas when "
        "given (a multiple of R), else R; every replica equals the JAX "
        "package's mesh run. A grid needs R*S logical devices: set "
        "SHADOW_TPU_TORCH_LOGICAL_DEVICES for several on one device "
        "(general.mesh)",
    )
    run_p.add_argument(
        "--checkpoint-dir", metavar="DIR",
        help="write versioned run checkpoints into DIR at --checkpoint-"
        "interval cadence; SIGINT/SIGTERM also write a final one "
        "(general.checkpoint_dir)",
    )
    run_p.add_argument(
        "--checkpoint-interval", metavar="TIME",
        help="sim-time cadence between checkpoints, e.g. '30 s' "
        "(general.checkpoint_interval; default 30 s)",
    )
    run_p.add_argument(
        "--resume", action="store_true",
        help="resume from the newest checkpoint in --checkpoint-dir and "
        "run to stop_time — bit-exact vs an uninterrupted run "
        "(general.resume)",
    )
    run_p.add_argument(
        "--autotune", type=float, nargs="?", const=-1.0, metavar="SECONDS",
        help="enable the compile-budget autotuner: a tiny-chunk compile "
        "probe walks experimental.rounds_per_chunk down so one config "
        "knob cannot blow the run's wall budget; optional SECONDS "
        "overrides experimental.autotune_budget_s (runtime/autotune.py; "
        "docs/usage.md)",
    )
    run_p.add_argument(
        "--no-autotune", action="store_true",
        help="force the autotuner off even when the config enables "
        "experimental.autotune",
    )
    run_p.add_argument(
        "--no-recover", action="store_true",
        help="disable rollback-and-regrow capacity recovery: fail fast "
        "on a CapacityError instead of regrowing the saturated buffer "
        "and replaying (experimental.recover)",
    )
    run_p.add_argument(
        "--chunk-watchdog", type=float, metavar="SECONDS",
        help="arm the chunk-dispatch watchdog: a chunk whose launch and "
        "probe fetch together (the launch waits on the chunk's device "
        "work; the kernel's first build is not counted) exceed SECONDS "
        "is abandoned and "
        "re-dispatched from the retained clean snapshot, counted like a "
        "recovery (experimental.chunk_watchdog_s; 0 = off; "
        "docs/robustness.md)",
    )
    run_p.add_argument(
        "--chaos-seed", type=int, metavar="N",
        help="seed for the chaos plane's own PRNG stream (resolves "
        "'at=auto' fault sites deterministically; chaos.seed; "
        "docs/robustness.md 'Chaos testing')",
    )
    run_p.add_argument(
        "--chaos-fault", action="append", metavar="SPEC",
        help="inject a deterministic fault: KIND[@AT][:key=val...], e.g. "
        "'capacity@2', 'stall@1:stall_s=0.5', 'compile:target=megakernel' "
        "(repeatable; kinds: capacity, stall, compile, ckpt-corrupt, "
        "ckpt-truncate, worker-kill, worker-hang, preempt; chaos.faults)",
    )
    sweep_p = sub.add_parser(
        "sweep",
        help="run a declarative parameter sweep: many seeds/variants "
        "packed into ensemble batches through a priority job queue with "
        "a compile cache and checkpoint-based preemption "
        "(docs/service.md)",
    )
    sweep_p.add_argument("spec", help="path to a sweep spec YAML")
    sweep_p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the batches' state lives (default: cuda)",
    )
    sweep_p.add_argument(
        "--output-dir",
        metavar="DIR",
        help="override the spec's output_dir (per-job data dirs and "
        "sweep-manifest.json land here)",
    )
    sweep_p.add_argument(
        "--show-plan",
        action="store_true",
        help="print the packing decision (jobs -> ensemble batches) as "
        "JSON and exit without running",
    )
    sweep_p.add_argument(
        "--metrics-file",
        metavar="PATH",
        help="stream the service's per-chunk samples and job/batch "
        "events as JSONL (docs/service.md)",
    )
    sweep_p.add_argument(
        "--metrics-prom",
        metavar="PATH",
        help="rewrite a Prometheus textfile snapshot of the service "
        "gauges (queue depth, preemptions, cache hits) after every "
        "scheduling decision — the sweep service's scrape endpoint "
        "(docs/service.md)",
    )
    serve_p = sub.add_parser(
        "serve",
        help="run the durable simulation daemon on a spool directory: "
        "live job arrivals (specs dropped into SPOOL/incoming/), a "
        "crash-safe write-ahead journal (SIGKILL loses zero admitted "
        "jobs), per-tenant quotas + weighted fair-share, a "
        "disk-persistent compile cache, an optional HTTP front door "
        "(--http), and fleet operation — N daemons, one spool, "
        "lease-based claims (docs/service.md 'Daemon mode')",
    )
    serve_p.add_argument(
        "spool", help="spool directory (created if missing; all durable "
        "daemon state — journal, jobs, checkpoints, cache — lives here)"
    )
    serve_p.add_argument(
        "--device", choices=("cuda", "cpu"), default="cuda",
        help="where the batches' state lives (default: cuda)",
    )
    serve_p.add_argument(
        "--drain",
        action="store_true",
        help="process every queued and spooled job, then exit instead "
        "of waiting for new arrivals (batch mode; also the "
        "crash-recovery idiom: restart with --drain to finish a dead "
        "daemon's queue)",
    )
    serve_p.add_argument(
        "--poll-interval", type=float, default=2.0, metavar="SECONDS",
        help="spool scan cadence, also honored mid-batch so live "
        "arrivals can preempt (default 2)",
    )
    serve_p.add_argument(
        "--prom-interval", type=float, default=10.0, metavar="SECONDS",
        help="wall-clock cadence for rewriting the --metrics-prom "
        "textfile and daemon-manifest.json while batches run "
        "(default 10)",
    )
    serve_p.add_argument(
        "--capacity", type=int, default=8, metavar="N",
        help="max jobs packed into one ensemble batch (default 8)",
    )
    serve_p.add_argument(
        "--retry-max", type=int, default=1, metavar="N",
        help="per-job retries before quarantine (default 1)",
    )
    serve_p.add_argument(
        "--max-queue", type=int, default=256, metavar="N",
        help="bounded-queue backpressure: admissions beyond N "
        "outstanding jobs are rejected with a journaled record "
        "(default 256)",
    )
    serve_p.add_argument(
        "--default-quota", type=int, default=64, metavar="N",
        help="per-tenant cap on outstanding jobs (default 64)",
    )
    serve_p.add_argument(
        "--quota", action="append", metavar="TENANT=N",
        help="override the outstanding-jobs quota for one tenant "
        "(repeatable)",
    )
    serve_p.add_argument(
        "--quota-class", action="append", metavar="T=device_seconds:N[,queue:M]",
        help="enforced per-tenant budget class: N device-seconds per "
        "--quota-window; new jobs from an over-budget tenant are "
        "refused (journaled reject + Retry-After), a RUNNING batch is "
        "checkpointed and parked at the next chunk boundary; queue:M "
        "overrides the outstanding-jobs quota (repeatable; "
        "docs/service.md 'Quota classes')",
    )
    serve_p.add_argument(
        "--quota-window", type=float, default=3600.0, metavar="SECONDS",
        help="quota-class accounting window: budgets refill when it "
        "rolls (default 3600)",
    )
    serve_p.add_argument(
        "--http", metavar="HOST:PORT",
        help="serve the HTTP front door on this address (port 0 binds "
        "an ephemeral port, published in SPOOL/http-address): POST "
        "/v1/jobs, GET /v1/jobs/{id}[/results|/events], GET /v1/metrics "
        "(docs/service.md 'HTTP front door')",
    )
    serve_p.add_argument(
        "--lease-s", type=float, default=30.0, metavar="SECONDS",
        help="batch-claim lease duration for fleet operation (N serve "
        "processes, one spool): leases renew at chunk ticks and a dead "
        "daemon's claims are reclaimed by survivors once expired "
        "(default 30; docs/service.md 'Running a fleet')",
    )
    serve_p.add_argument(
        "--daemon-id", metavar="ID",
        help="this daemon's fleet identity in claims/leases and the "
        "manifest (default HOSTNAME.PID)",
    )
    serve_p.add_argument(
        "--weight", action="append", metavar="TENANT=W",
        help="fair-share weight for one tenant (higher = more service "
        "within a priority level; default 1.0; repeatable)",
    )
    serve_p.add_argument(
        "--keep-batch-dirs", type=int, default=8, metavar="K",
        help="retention for per-batch checkpoint dirs: finished "
        "batches' checkpoints are removed immediately, leftovers "
        "beyond the newest K pruned (default 8)",
    )
    serve_p.add_argument(
        "--cache-dir", metavar="DIR",
        help="persistent compile-cache directory (default SPOOL/cache)",
    )
    serve_p.add_argument(
        "--no-cache-persist", action="store_true",
        help="keep the compile cache in-memory only (the pre-daemon "
        "behavior: prepared chunks die with the process)",
    )
    serve_p.add_argument(
        "--metrics-file", metavar="PATH",
        help="stream service samples/events as JSONL; rotates at "
        "--metrics-max-mb keeping --metrics-keep segments",
    )
    serve_p.add_argument(
        "--metrics-max-mb", type=float, default=64.0, metavar="MB",
        help="metrics JSONL rotation cap (default 64; 0 = unbounded)",
    )
    serve_p.add_argument(
        "--metrics-keep", type=int, default=3, metavar="N",
        help="rotated metrics segments kept (default 3)",
    )
    serve_p.add_argument(
        "--metrics-prom", metavar="PATH",
        help="Prometheus textfile snapshot: sweep gauges plus "
        "shadow_tpu_daemon_uptime_seconds and the "
        "shadow_tpu_tenant_queue_depth{tenant=...} family, rewritten "
        "at --prom-interval cadence even mid-batch",
    )
    serve_p.add_argument(
        "--mesh", metavar="RxS",
        help="dispatch every packed batch over a 2-D grid of logical "
        "devices, R replica rows x S host-shards; packing prefers batch "
        "sizes that fill whole rows, and ragged or split batches degrade "
        "their rows",
    )
    serve_p.add_argument(
        "--journal-compact-every", type=int, default=512, metavar="N",
        help="fold terminal journal records into a sha-digested "
        "snapshot + tail once N record files accumulate, so a "
        "months-long spool's journal stays bounded (default 512; "
        "0 = never compact)",
    )
    serve_p.add_argument(
        "--chaos-seed", type=int, metavar="N",
        help="chaos-plane PRNG seed (docs/robustness.md)",
    )
    serve_p.add_argument(
        "--chaos-fault", action="append", metavar="SPEC",
        help="inject a deterministic daemon fault, e.g. "
        "'daemon-kill@2:target=chunk', 'spool-corrupt@1', "
        "'cache-corrupt@0' (repeatable; plus every run-level kind)",
    )
    submit_p = sub.add_parser(
        "submit",
        help="atomically drop a job spec into a daemon spool's "
        "incoming/ directory (write-then-rename, so the daemon never "
        "reads a torn file)",
    )
    submit_p.add_argument("spool", help="the daemon's spool directory")
    submit_p.add_argument("spec", help="path to a job spec YAML "
                          "(a 'job:' mapping; docs/service.md)")
    submit_p.add_argument(
        "--tenant", metavar="NAME",
        help="set/override job.tenant in the submitted spec",
    )
    submit_p.add_argument(
        "--wait", action="store_true",
        help="after spooling, poll until every submitted job is "
        "terminal; exit 0 iff all done (1 = failed/quarantined/"
        "rejected, 2 = --timeout expired)",
    )
    submit_p.add_argument(
        "--timeout", type=float, metavar="SECONDS",
        help="give up on --wait after this long (exit 2; default: "
        "wait forever)",
    )
    submit_p.add_argument(
        "--http", metavar="URL",
        help="with --wait, poll the daemon's HTTP status endpoint "
        "(e.g. http://127.0.0.1:8080) instead of reading the journal — "
        "works from hosts that cannot see the spool filesystem",
    )
    mem_p = sub.add_parser(
        "mem",
        help="price a config's device memory without allocating it: a "
        "bytes/host table grouped by subsystem, the dominant grid, and a "
        "max-hosts projection for a device memory budget",
    )
    mem_p.add_argument("config", help="path to the config YAML")
    mem_p.add_argument(
        "--hbm-gb", type=float, default=None, metavar="GB",
        help="project how many hosts of this world fit a device memory "
        "budget of GB gibibytes",
    )
    mem_p.add_argument(
        "--replicas", type=int, default=None, metavar="R",
        help="price the [R]-batched ensemble state instead of the "
        "single-world state",
    )
    mem_p.add_argument(
        "--mesh", metavar="SPEC",
        help="price the RxS mesh-sharded state (e.g. '2x4')",
    )
    mem_p.add_argument(
        "--json", action="store_true",
        help="emit the raw pricing report as JSON instead of the table",
    )
    metrics_p = sub.add_parser(
        "metrics",
        help="summarize a recorded metrics series: a --metrics-file "
        "JSONL stream or a flight-recorder.json black box — per-metric "
        "percentiles, sparklines, and the event/failure log",
    )
    metrics_p.add_argument(
        "file", help="path to a metrics JSONL stream or flight-recorder.json"
    )
    metrics_p.add_argument(
        "--follow", action="store_true",
        help="tail mode: re-render the summary whenever the stream "
        "grows (watch a live run; Ctrl-C to stop)",
    )
    metrics_p.add_argument(
        "--interval", type=float, default=2.0, metavar="SECONDS",
        help="--follow poll cadence (default 2)",
    )
    metrics_p.add_argument(
        "--max-updates", type=int, default=None, metavar="N",
        help="stop --follow after N re-renders (default: until Ctrl-C)",
    )
    sub.add_parser(
        "shm-cleanup",
        help="remove stale shared-memory blocks left by crashed runs "
        "(the reference's --shm-cleanup, main.rs:333)",
    )
    args = parser.parse_args(argv)

    if args.command == "run":
        from shadow_tpu_torch.runtime.cli_run import CliUserError, run_from_config

        try:
            return run_from_config(
                args.config, device=args.device, show_config=args.show_config,
                replicas=args.replicas, replica_seed_stride=args.replica_seed_stride,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_interval=args.checkpoint_interval,
                resume=args.resume, no_recover=args.no_recover,
                tracker=args.tracker, trace_file=args.trace_file,
                metrics_file=args.metrics_file, metrics_prom=args.metrics_prom,
                xprof_dir=args.xprof_dir, xprof_chunks=args.xprof_chunks,
                autotune=args.autotune, no_autotune=args.no_autotune,
                chunk_watchdog=args.chunk_watchdog, chaos_seed=args.chaos_seed,
                chaos_faults=args.chaos_fault, mesh=args.mesh,
            )
        except CliUserError as e:
            print(f"shadow-tpu-torch: error: {e}", file=sys.stderr)
            return 1
        except RuntimeError as e:
            if "CUDA not available" not in str(e):
                raise
            print(f"shadow-tpu-torch: error: {e}", file=sys.stderr)
            return 1
    if args.command == "sweep":
        from shadow_tpu_torch.runtime.cli_run import CliUserError, run_sweep

        try:
            return run_sweep(
                args.spec, output_dir=args.output_dir, show_plan=args.show_plan,
                metrics_file=args.metrics_file, metrics_prom=args.metrics_prom,
                device=args.device,
            )
        except CliUserError as e:
            print(f"shadow-tpu-torch: error: {e}", file=sys.stderr)
            return 1
        except RuntimeError as e:
            if "CUDA not available" not in str(e):
                raise
            print(f"shadow-tpu-torch: error: {e}", file=sys.stderr)
            return 1
    if args.command == "serve":
        from shadow_tpu_torch.runtime.cli_run import CliUserError, run_serve

        try:
            return run_serve(
                args.spool, drain=args.drain, poll_interval=args.poll_interval,
                prom_interval=args.prom_interval, capacity=args.capacity,
                retry_max=args.retry_max, max_queue=args.max_queue,
                default_quota=args.default_quota, quotas=args.quota,
                quota_classes=args.quota_class, quota_window=args.quota_window,
                weights=args.weight, http=args.http, lease_s=args.lease_s,
                daemon_id=args.daemon_id, keep_batch_dirs=args.keep_batch_dirs,
                cache_dir=args.cache_dir, no_cache_persist=args.no_cache_persist,
                metrics_file=args.metrics_file, metrics_max_mb=args.metrics_max_mb,
                metrics_keep=args.metrics_keep, metrics_prom=args.metrics_prom,
                chaos_seed=args.chaos_seed, chaos_faults=args.chaos_fault,
                mesh=args.mesh, journal_compact_every=args.journal_compact_every,
                device=args.device,
            )
        except CliUserError as e:
            print(f"shadow-tpu-torch: error: {e}", file=sys.stderr)
            return 1
        except RuntimeError as e:
            if "CUDA not available" not in str(e):
                raise
            print(f"shadow-tpu-torch: error: {e}", file=sys.stderr)
            return 1
    if args.command == "submit":
        from shadow_tpu_torch.runtime.cli_run import CliUserError, run_submit

        try:
            return run_submit(args.spool, args.spec, tenant=args.tenant, wait=args.wait,
                              timeout=args.timeout, http=args.http)
        except CliUserError as e:
            print(f"shadow-tpu-torch: error: {e}", file=sys.stderr)
            return 1
    if args.command == "mem":
        from shadow_tpu_torch.runtime.cli_run import CliUserError, run_mem

        try:
            return run_mem(args.config, hbm_gb=args.hbm_gb, replicas=args.replicas,
                           mesh=args.mesh, json_out=args.json)
        except CliUserError as e:
            print(f"shadow-tpu-torch: error: {e}", file=sys.stderr)
            return 1
    if args.command == "metrics":
        from shadow_tpu_torch.runtime.flightrec import follow_file, render_summary_file

        try:
            if args.follow:
                follow_file(args.file, interval_s=args.interval, max_updates=args.max_updates)
                return 0
            print(render_summary_file(args.file))
        except KeyboardInterrupt:
            return 0  # the way a --follow session ends
        except (OSError, ValueError) as e:
            print(f"shadow-tpu-torch: error: {e}", file=sys.stderr)
            return 1
        return 0
    if args.command == "shm-cleanup":
        return shm_cleanup()
    parser.print_help()
    return 2


def shm_cleanup(shm_dir: str = "/dev/shm") -> int:
    """Remove shadow-tpu shm blocks no live process has mapped
    (reference: shm_cleanup.rs checks owner liveness the same way).
    Blocks are named shadow-tpu-<tag>-* (hostk/ipc.py makes them)."""
    import pathlib
    import time

    def mapped_paths():
        mapped = set()
        for maps in pathlib.Path("/proc").glob("[0-9]*/maps"):
            try:
                for line in maps.read_text().splitlines():
                    if "shadow-tpu-" in line:
                        mapped.add(line.split(maxsplit=5)[-1].split(" (deleted)")[0])
            except OSError:
                continue  # process went away mid-scan
        return mapped

    live = mapped_paths()
    removed = 0
    now = time.time()
    for p in pathlib.Path(shm_dir).glob("shadow-tpu-*"):
        if str(p) in live:
            continue  # a running simulation still maps this block
        try:
            if now - p.stat().st_mtime < 5:
                continue  # created moments ago: may not be mapped yet
        except OSError:
            continue
        try:
            p.unlink()
            removed += 1
        except OSError:
            pass
    print(f"shm-cleanup: removed {removed} stale block(s) from {shm_dir}")
    return 0
