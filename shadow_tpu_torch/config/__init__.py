from shadow_tpu_torch.config.fingerprint import config_fingerprint, fingerprint_dict
from shadow_tpu_torch.config.options import (
    ConfigOptions,
    GeneralOptions,
    HostOptions,
    NetworkOptions,
    ExperimentalOptions,
    ProcessOptions,
    deep_merge,
    load_config_file,
    load_config_str,
)

__all__ = [
    "ConfigOptions",
    "GeneralOptions",
    "HostOptions",
    "NetworkOptions",
    "ExperimentalOptions",
    "ProcessOptions",
    "config_fingerprint",
    "deep_merge",
    "fingerprint_dict",
    "load_config_file",
    "load_config_str",
]
