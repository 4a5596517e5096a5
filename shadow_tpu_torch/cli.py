"""`python -m shadow_tpu_torch run CONFIG` (port of shadow_tpu/cli.py:
the `run`, `mem` and `metrics` subcommands). `run` runs on the GPU
unless `--device cpu` is given; `mem` prices a config's state without
allocating it, and `metrics` renders a recorded metrics series."""

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
        help="price the RxS mesh-sharded state (e.g. '2x4'; not yet ported)",
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
                chaos_faults=args.chaos_fault,
            )
        except CliUserError as e:
            print(f"shadow-tpu-torch: error: {e}", file=sys.stderr)
            return 1
        except RuntimeError as e:
            if "CUDA not available" not in str(e):
                raise
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
    parser.print_help()
    return 2
