"""Event identity and total ordering (port of shadow_tpu/events.py).

An event is totally ordered by the pair (time_i64, tie_i64), where the
tie packs (variant, src_host, seq):

tie layout (MSB..LSB):  [bit 62: variant][30 bits src_host][32 bits seq]
variant: 0 = Packet, 1 = Local (Packet sorts first, as in the reference).
"""

from __future__ import annotations

import torch

KIND_INVALID = -1
KIND_PACKET = 0  # a packet arriving at a host's upstream router
KIND_MODEL_BASE = 1  # local (task/timer) kinds start here

_SEQ_BITS = 32
_SRC_BITS = 30
SEQ_MASK = (1 << _SEQ_BITS) - 1
SRC_MASK = (1 << _SRC_BITS) - 1
MAX_HOSTS = 1 << _SRC_BITS


def pack_tie(kind, src_host, seq):
    """Pack ordering tie-break fields into one i64. Works on ints or
    tensors (any int dtype; seq wraps at 2**32)."""
    if isinstance(kind, torch.Tensor):
        variant = (kind != KIND_PACKET).to(torch.int64)
        return (
            (variant << (_SRC_BITS + _SEQ_BITS))
            | ((src_host.to(torch.int64) & SRC_MASK) << _SEQ_BITS)
            | (seq.to(torch.int64) & SEQ_MASK)
        )
    if not (0 <= int(src_host) < MAX_HOSTS):
        raise ValueError(f"src_host {src_host} out of range [0, {MAX_HOSTS})")
    return (
        (int(kind != KIND_PACKET) << (_SRC_BITS + _SEQ_BITS))
        | (int(src_host) << _SEQ_BITS)
        | (int(seq) & SEQ_MASK)
    )


def tie_src_host(tie):
    return (tie >> _SEQ_BITS) & SRC_MASK


def tie_seq(tie):
    return tie & SEQ_MASK


def tie_is_local(tie):
    return (tie >> (_SRC_BITS + _SEQ_BITS)) & 1
