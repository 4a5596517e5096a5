"""`python -m shadow_tpu_torch run CONFIG` (port of shadow_tpu/cli.py,
the `run` subcommand). Runs on the GPU unless `--device cpu` is given."""

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
        "--no-recover", action="store_true",
        help="disable rollback-and-regrow capacity recovery: fail fast "
        "on a CapacityError instead of regrowing the saturated buffer "
        "and replaying (experimental.recover)",
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
            )
        except CliUserError as e:
            print(f"shadow-tpu-torch: error: {e}", file=sys.stderr)
            return 1
        except RuntimeError as e:
            if "CUDA not available" not in str(e):
                raise
            print(f"shadow-tpu-torch: error: {e}", file=sys.stderr)
            return 1
    parser.print_help()
    return 2
