"""shadow_tpu_torch — the PyTorch/CUDA port of shadow_tpu.

The same conservative-PDES network simulator as `shadow_tpu/`, with hosts
as rows of device-resident torch tensors, laid out module for module like
the JAX package so that every module has an obvious counterpart there.
The JAX package is the reference: for the same config and seed, every
state leaf of a port run equals the reference's.

What differs from the JAX package:
  * plain functions on tensors, dataclasses of tensors in place of
    flax pytrees, and an explicit `device` on every entry point (the
    card, "cuda", unless the caller asks for "cpu");
  * the packet-pump megakernel is a CUDA C++ kernel for sm_90a
    (csrc/pump_megakernel.cu) with a torch-op twin (engine/pump.py);
  * u32 quantities (sequence and draw counters, threefry key words) are
    carried in int64 tensors holding values in [0, 2**32).

Importing this package imports torch and numpy only, never jax.
"""

from shadow_tpu_torch.simtime import (  # noqa: F401
    NS_PER_MS,
    NS_PER_SEC,
    NS_PER_US,
    SIM_START_UNIX_NS,
    TIME_MAX,
)

__version__ = "0.1.0"
