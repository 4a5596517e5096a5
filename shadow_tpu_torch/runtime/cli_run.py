"""`run` and `mem` implementations (port of shadow_tpu/runtime/cli_run.py,
reduced to the single-device scripted run, its ensemble of replicas and
the cpu-ref oracle). User mistakes surface as CliUserError and print as one-line
errors."""

from __future__ import annotations

import json
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
                    chaos_faults: "list[str] | None" = None) -> int:
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
        # the world is validated as a run validates it; nothing is placed
        # on a device (device="cpu" only names where tables would live)
        world = Manager(config, device="cpu").build_world()
    except (ValueError, OSError) as e:
        raise CliUserError(str(e)) from e
    report = memtrack.price_state(priced_state(world, config.general.replicas), world.ecfg)
    if json_out:
        print(json.dumps(report, indent=2))
    else:
        print(memtrack.render_report(report, hbm_gb=hbm_gb))
    return 0
