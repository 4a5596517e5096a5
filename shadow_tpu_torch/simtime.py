"""Simulation-time types and constants.

Mirrors the reference's two time domains (reference:
src/lib/shadow-shim-helper-rs/src/emulated_time.rs:25-48 and
simulation_time.rs): `SimulationTime` is ns since simulation start,
`EmulatedTime` is ns since 2000-01-01T00:00:00Z (the fixed epoch managed
processes observe, which makes wall-clock reads deterministic).

Everything on-device is a plain i64 ns count in the *simulation* domain;
these helpers convert and pretty-print at the (CPU) edges.
"""

from __future__ import annotations

import datetime

# EmulatedTime epoch: 2000-01-01T00:00:00Z, expressed in Unix ns.
# reference: src/lib/shadow-shim-helper-rs/src/emulated_time.rs:25-34
SIM_START_UNIX_NS = int(
    datetime.datetime(2000, 1, 1, tzinfo=datetime.timezone.utc).timestamp() * 1_000_000_000
)

NS_PER_US = 1_000
NS_PER_MS = 1_000_000
NS_PER_SEC = 1_000_000_000

# Sentinel for "no event" / "never": the largest i64 we use for times. Kept
# well below i64::MAX so that (TIME_MAX + latency) cannot overflow.
TIME_MAX = (1 << 62) - 1


def parse_time_ns(s: "str | int | float") -> int:
    """Parse a human time string ('10 ms', '2 sec', '1 min', '30') to ns.

    Bare numbers are seconds, matching the reference config convention
    (reference: src/main/core/support/units.rs — TimePrefixUpper parsing).
    """
    if isinstance(s, (int, float)):
        return int(s * NS_PER_SEC)
    s = s.strip()
    # split number / suffix
    i = 0
    while i < len(s) and (s[i].isdigit() or s[i] in ".+-eE"):
        i += 1
    num = float(s[:i])
    suffix = s[i:].strip().lower()
    scale = {
        "": NS_PER_SEC,
        "ns": 1,
        "nanosecond": 1,
        "nanoseconds": 1,
        "us": NS_PER_US,
        "μs": NS_PER_US,
        "microsecond": NS_PER_US,
        "microseconds": NS_PER_US,
        "ms": NS_PER_MS,
        "millisecond": NS_PER_MS,
        "milliseconds": NS_PER_MS,
        "s": NS_PER_SEC,
        "sec": NS_PER_SEC,
        "secs": NS_PER_SEC,
        "second": NS_PER_SEC,
        "seconds": NS_PER_SEC,
        "m": 60 * NS_PER_SEC,
        "min": 60 * NS_PER_SEC,
        "mins": 60 * NS_PER_SEC,
        "minute": 60 * NS_PER_SEC,
        "minutes": 60 * NS_PER_SEC,
        "h": 3600 * NS_PER_SEC,
        "hr": 3600 * NS_PER_SEC,
        "hour": 3600 * NS_PER_SEC,
        "hours": 3600 * NS_PER_SEC,
    }.get(suffix)
    if scale is None:
        raise ValueError(f"unknown time suffix {suffix!r} in {s!r}")
    return round(num * scale)


def fmt_time_ns(t: int) -> str:
    """Render a sim-time ns count as the emulated wall-clock instant."""
    if t >= TIME_MAX:
        return "never"
    unix_ns = SIM_START_UNIX_NS + int(t)
    dt = datetime.datetime.fromtimestamp(unix_ns // NS_PER_SEC, tz=datetime.timezone.utc)
    return dt.strftime("%Y-%m-%d %H:%M:%S") + f".{(unix_ns % NS_PER_SEC):09d}"
