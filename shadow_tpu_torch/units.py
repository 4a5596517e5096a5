"""Typed unit parsing for config values (reference: src/main/core/support/units.rs).

Bandwidths parse to bits/second; byte sizes to bytes; times live in
shadow_tpu_torch.simtime. Suffix grammar matches the reference's SI/binary
prefixes: e.g. "1 Gbit", "100 Mbit", "16 KiB", "10 MB".
"""

from __future__ import annotations

import re

_SI = {"K": 10**3, "M": 10**6, "G": 10**9, "T": 10**12}
_BIN = {"KI": 2**10, "MI": 2**20, "GI": 2**30, "TI": 2**40}

_VALUE = re.compile(
    r"\s*([-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?)\s*([KMGTkmgt][iI]?)?\s*([A-Za-z/]*)\s*"
)


def _parse(s: str, base_units: set, what: str) -> float:
    m = _VALUE.fullmatch(s)
    if not m:
        raise ValueError(f"cannot parse {what} {s!r}")
    num = float(m.group(1))
    prefix = (m.group(2) or "").upper()
    unit = m.group(3).lower()
    scale = 1 if not prefix else (_BIN.get(prefix) if prefix.endswith("I") else _SI.get(prefix))
    if scale is None:
        raise ValueError(f"unknown prefix {m.group(2)!r} in {what} {s!r}")
    if unit not in base_units:
        raise ValueError(f"unknown unit {unit!r} in {what} {s!r}")
    return num * scale


def parse_bandwidth_bits_per_sec(s: "str | int | float") -> int:
    """'1 Gbit' -> 10**9 (bits/sec). Bare numbers are bits/sec."""
    if isinstance(s, (int, float)):
        return int(s)
    return round(_parse(s, {"", "bit", "b", "bps", "bit/s", "bits"}, "bandwidth"))


def parse_bytes(s: "str | int | float") -> int:
    """'16 KiB' -> 16384; '10 MB' -> 10**7. Bare numbers are bytes."""
    if isinstance(s, (int, float)):
        return int(s)
    return round(_parse(s, {"", "byte", "bytes"} | {"b"}, "size"))
