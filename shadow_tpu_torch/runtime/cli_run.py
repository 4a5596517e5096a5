"""`run` implementation (port of shadow_tpu/runtime/cli_run.py, reduced
to the single-device scripted run and its ensemble of replicas). User mistakes surface as
CliUserError and print as one-line errors."""

from __future__ import annotations

import json

import yaml

from shadow_tpu_torch.config import load_config_file
from shadow_tpu_torch.engine.round import CapacityError
from shadow_tpu_torch.runtime.manager import Manager
from shadow_tpu_torch.utils.shadow_log import set_level


class CliUserError(Exception):
    pass


def run_from_config(path: str, device: str = "cuda", show_config: bool = False,
                    replicas: "int | None" = None,
                    replica_seed_stride: "int | None" = None) -> int:
    try:
        config = load_config_file(path)
    except (ValueError, OSError, yaml.YAMLError) as e:
        raise CliUserError(f"invalid config: {e}") from e
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
    except (CapacityError, ValueError) as e:
        raise CliUserError(str(e)) from e
    if results.unexpected_final_states:
        return 1
    return 0 if results.packets_unroutable == 0 else 1
