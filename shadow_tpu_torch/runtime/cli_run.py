"""`run` implementation (port of shadow_tpu/runtime/cli_run.py, reduced
to the single-device scripted run and its ensemble of replicas). User mistakes surface as
CliUserError and print as one-line errors."""

from __future__ import annotations

import json
import sys

import yaml

from shadow_tpu_torch.config import load_config_file
from shadow_tpu_torch.engine.round import CapacityError, RunInterrupted
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
                    resume: bool = False, no_recover: bool = False) -> int:
    try:
        config = load_config_file(path)
    except (ValueError, OSError, yaml.YAMLError) as e:
        raise CliUserError(f"invalid config: {e}") from e
    # CLI flags override the config's general/experimental sections
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
    if replicas is not None:
        if replicas < 1:
            raise CliUserError("--replicas must be >= 1")
        config.general.replicas = replicas
    if replica_seed_stride is not None:
        if replica_seed_stride < 1:
            raise CliUserError("--replica-seed-stride must be >= 1")
        config.general.replica_seed_stride = replica_seed_stride
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
    except (CapacityError, CheckpointError, ValueError) as e:
        # recovery budget exhausted, checkpoint/resume validation
        # (fingerprint mismatch, missing checkpoint), config mistakes
        raise CliUserError(str(e)) from e
    if results.unexpected_final_states:
        return 1
    return 0 if results.packets_unroutable == 0 else 1
