"""Where the port's tensors live. Entry points take a `device` that is
the card ("cuda") unless the caller asks for the CPU.

Logical devices are the multi-device planes' unit of placement (the
sharded engine and the 2-D mesh): the counterpart of the reference's
jax device list. Each physical device of a type presents
`SHADOW_TPU_TORCH_LOGICAL_DEVICES` logical devices (default 1), numbered
0 .. N * k - 1 over the k physical devices of that type, the first N on
the first physical device. It is the port's form of XLA's
`--xla_force_host_platform_device_count`: a grid of 8 logical devices
runs on one card or on the CPU. Logical devices that share a physical
device share its memory and its stream; a shard's tensors still move
between logical devices only through `.to(device)` in the exchange
steps, which is a copy only between different physical devices."""

from __future__ import annotations

import dataclasses
import os

import torch

LOGICAL_DEVICES_ENV = "SHADOW_TPU_TORCH_LOGICAL_DEVICES"


def resolve_device(device) -> torch.device:
    """The torch device an entry point runs on. Asking for the card on a
    machine without one is an error, never a silent CPU run."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA not available: this entry point runs on the GPU unless "
            "asked for the CPU (pass device='cpu', or --device cpu)"
        )
    return dev


@dataclasses.dataclass(frozen=True)
class LogicalDevice:
    """One logical device: its id in the visible list (the reference's
    jax device id) and the physical torch device that holds its
    tensors."""

    id: int
    physical: torch.device


def logical_per_physical() -> int:
    """N of SHADOW_TPU_TORCH_LOGICAL_DEVICES, read at every call (a test
    sets it for its own scope); 1 when unset."""
    raw = os.environ.get(LOGICAL_DEVICES_ENV, "").strip()
    if not raw:
        return 1
    try:
        n = int(raw)
    except ValueError as e:
        raise ValueError(f"{LOGICAL_DEVICES_ENV}={raw!r} must be an integer >= 1") from e
    if n < 1:
        raise ValueError(f"{LOGICAL_DEVICES_ENV}={raw!r} must be an integer >= 1")
    return n


def visible_devices(device="cuda") -> "list[LogicalDevice]":
    """The logical devices of `device`'s type, in id order: the port's
    jax.devices(). On the card, N per visible CUDA device; on the CPU, N
    on the one CPU device."""
    dev = resolve_device(device)
    n = logical_per_physical()
    if dev.type == "cuda":
        physical = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        physical = [torch.device(dev.type)]
    return [LogicalDevice(p * n + k, phys) for p, phys in enumerate(physical) for k in range(n)]


def logical_of(device) -> LogicalDevice:
    """The first logical device of a physical torch device: where a
    single-device run's state lives in the logical numbering."""
    dev = torch.device(device)
    index = (dev.index or 0) if dev.type == "cuda" else 0
    return LogicalDevice(index * logical_per_physical(), dev)
