"""Static memory pricing — layer 1 of the memory observatory (port of
shadow_tpu/runtime/memtrack.py).

Hosts are rows of a resident state tensor, so "does this world fit, and
what do I shrink if not" must be answerable before a run allocates its
state. This module walks a SimState — single or ensemble `[R, H, ...]`
— and produces an exact bytes/host table grouped by subsystem, names
the dominant grid, and projects the hosts that fit a device budget.
Every number is the sum of the tensors' bytes as the port holds them:
`seq`, `rng_counter` and the two `rng_key` words are int64 here where
the reference keeps uint32 words, 16 B a host more, and the table says
so. A state built on `torch.device("meta")` has shapes and dtypes and no
storage, so `mem` prices a config without allocating anything.

`device_memory` reads the CUDA caching allocator's counters for live
sampling (runtime/flightrec.py) and the sim-stats `memory` section: host
reads, no device sync, and None on the CPU, where the reference's CPU
backend reports none either. The third reader, `compiled_memory`,
reports a compile-cache entry's memory (runtime/compile_cache.py): the
reference reads XLA's analysis of an executable; the port reads the CUDA
allocator's peaks over the entry's build and its first launch.
"""

from __future__ import annotations

from shadow_tpu_torch.engine.state import (
    buffer_nbytes,
    fmt_bytes,
    leaf_nbytes,
    price_regrow,
    tree_nbytes,
)
from shadow_tpu_torch.utils.tree import tree_leaves_with_path

__all__ = [
    "price_state",
    "price_regrow",
    "max_hosts_for_budget",
    "render_report",
    "memory_section",
    "compiled_memory",
    "device_memory",
    "fmt_bytes",
    "leaf_nbytes",
    "tree_nbytes",
]

# top-level SimState field -> subsystem group in the table
_GROUP_BY_FIELD = {
    "queue": "queue",
    "outbox": "outbox",
    "net": "net",
    "model": "model",
    "tracker": "tracker",
    "rng_key": "rng",
    "rng_counter": "rng",
    "seq": "rng",
}
_GROUP_ORDER = ("queue", "outbox", "net", "model", "tracker", "rng", "counters")


def _dtype_name(leaf) -> str:
    """The reference's spelling of a leaf dtype ("int64", "bool")."""
    return str(leaf.dtype).removeprefix("torch.")


def price_state(st, cfg=None) -> dict:
    """Walk a SimState (on any device, `meta` included) into the
    bytes/host report. The leading replica axis of an ensemble state is
    detected from the `now` leaf; `bytes_per_host` is total/hosts — the
    marginal cost of one more host row across all replicas, the number
    the max-hosts projection divides by.

    With `cfg` (EngineConfig), the report adds the transient exchange
    pool projection for segment-exchange runs: the flush's sorted pool
    is round-local, not resident state, but it is device memory the
    chunk touches (pool_capacity slots, 0 = the whole outbox)."""
    replicas = int(st.now.shape[0]) if st.now.dim() >= 1 else 1
    num_hosts = int(st.seq.shape[-1])

    groups: dict = {}
    dominant = None
    total = 0
    for path, leaf in tree_leaves_with_path(st):
        name = path.lstrip(".")
        group = _GROUP_BY_FIELD.get(name.split(".", 1)[0], "counters")
        b = leaf_nbytes(leaf)
        total += b
        g = groups.setdefault(group, {"bytes": 0, "grids": []})
        g["bytes"] += b
        g["grids"].append(
            {
                "name": name,
                "shape": [int(s) for s in leaf.shape],
                "dtype": _dtype_name(leaf),
                "bytes": b,
            }
        )
        if dominant is None or b > dominant["bytes"]:
            dominant = {"group": group, **g["grids"][-1]}
    for g in groups.values():
        g["grids"].sort(key=lambda r: -r["bytes"])
        if num_hosts:
            g["bytes_per_host"] = round(g["bytes"] / num_hosts, 2)

    report = {
        "num_hosts": num_hosts,
        "replicas": replicas,
        "total_bytes": int(total),
        "bytes_per_host": round(total / num_hosts, 2) if num_hosts else 0.0,
        "groups": groups,
        "dominant": dominant,
    }
    if cfg is not None and getattr(cfg, "exchange", "") == "segment" and num_hosts:
        # slot width from the outbox leaves (the pool compacts outbox
        # slots), per replica-row of the batch
        ob = st.outbox
        row_bytes = (buffer_nbytes(ob, ob.fill.dim())
                     - leaf_nbytes(ob.fill) - leaf_nbytes(ob.overflow))
        o_cap = int(ob.valid.shape[-1])
        slot = row_bytes // max(num_hosts * o_cap * replicas, 1)
        slots = cfg.pool_capacity or num_hosts * o_cap
        report["exchange_pool_transient_bytes"] = int(slot * slots * replicas)
    return report


def max_hosts_for_budget(report: dict, budget_bytes: int) -> int:
    """How many hosts of THIS world (same config, same replica count)
    fit in `budget_bytes` of device memory: the per-host marginal bytes
    divide the budget after the host-independent scalars are set aside.
    Monotonic in the budget by construction."""
    per_host = report["bytes_per_host"]
    if per_host <= 0:
        return 0
    fixed = sum(
        g["bytes"]
        for r in report["groups"].values()
        for g in r["grids"]
        if not g["shape"]  # scalar leaves don't scale with hosts
    )
    return max(0, int((budget_bytes - fixed) // per_host))


def render_report(report: dict, hbm_gb: "float | None" = None) -> str:
    """The `mem` table: per-subsystem bytes/host, the dominant grid, and
    the max-hosts projection (the reference's text, but for what its
    projection line says comes on top of the state)."""
    h, r = report["num_hosts"], report["replicas"]
    head = f"{h} hosts" + (f" x {r} replicas" if r > 1 else "")
    lines = [
        f"memory: {head}, total {fmt_bytes(report['total_bytes'])} "
        f"({fmt_bytes(report['bytes_per_host'])}/host)",
        f"  {'subsystem':<10} {'bytes':>12} {'bytes/host':>12}  largest grid",
    ]
    for name in _GROUP_ORDER:
        g = report["groups"].get(name)
        if g is None:
            continue
        top = g["grids"][0]
        shape = "x".join(str(s) for s in top["shape"]) or "scalar"
        lines.append(
            f"  {name:<10} {fmt_bytes(g['bytes']):>12} "
            f"{fmt_bytes(g.get('bytes_per_host', 0)):>12}  "
            f"{top['name']} [{shape}] {top['dtype']}"
        )
    dom = report["dominant"]
    shape = "x".join(str(s) for s in dom["shape"]) or "scalar"
    lines.append(
        f"  dominant grid: {dom['name']} [{shape}] {dom['dtype']} = "
        f"{fmt_bytes(dom['bytes'])} "
        f"({100 * dom['bytes'] / max(report['total_bytes'], 1):.1f}% of state)"
    )
    if "exchange_pool_transient_bytes" in report:
        lines.append(
            "  + transient exchange pool (segment flush): "
            f"{fmt_bytes(report['exchange_pool_transient_bytes'])}"
        )
    if hbm_gb:
        budget = int(hbm_gb * 1024**3)
        fits = max_hosts_for_budget(report, budget)
        lines.append(
            f"  projection: {fits} hosts fit in {hbm_gb:g} GiB HBM "
            f"(state only; the run's temporaries and kernel scratch "
            f"come on top)"
        )
    return "\n".join(lines)


def memory_section(st, cfg=None) -> dict:
    """The compact `memory` block for sim-stats.json: group totals, the
    dominant grid and the device's allocator numbers where the state
    lives on the card (the full grid list stays in `mem`)."""
    report = price_state(st, cfg=cfg)
    out = {
        "num_hosts": report["num_hosts"],
        "replicas": report["replicas"],
        "total_bytes": report["total_bytes"],
        "bytes_per_host": report["bytes_per_host"],
        "groups": {name: g["bytes"] for name, g in report["groups"].items()},
        "dominant": report["dominant"],
    }
    if "exchange_pool_transient_bytes" in report:
        out["exchange_pool_transient_bytes"] = report["exchange_pool_transient_bytes"]
    dev = device_memory(st.now.device)
    if dev is not None:
        out["device"] = dev
    return out


def device_memory(device=None, limit: bool = True) -> "dict | None":
    """The CUDA caching allocator's counters for `device` (None = the
    current CUDA device, if this process has initialised CUDA):
    bytes_in_use (allocated_bytes.all.current), peak_bytes_in_use
    (allocated_bytes.all.peak) and, with `limit`, bytes_limit (the
    card's total memory, from cudaMemGetInfo). Host reads, no device
    sync. None on the CPU (and on `meta`), so every caller treats
    device memory as optional."""
    try:
        import torch

        if device is None:
            if not torch.cuda.is_initialized():
                return None
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return None
        ms = torch.cuda.memory_stats(device)
        out = {
            "bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0)),
        }
        if limit:
            out["bytes_limit"] = int(torch.cuda.mem_get_info(device)[1])
        return out
    except Exception:  # noqa: BLE001 — diagnostics, never a failure
        return None


def compiled_memory(exe) -> "dict | None":
    """A prepared chunk's memory (engine/ensemble.py EnsembleChunk): the
    CUDA allocator's peak over its build (`build_peak_bytes`), over its
    first launch once that has run (`launch_peak_bytes`), and the larger
    as `peak_bytes`. None for a chunk prepared on the CPU, or for
    anything else: the reference's "backend does not report" branch."""
    peaks = {
        k: int(v)
        for k in ("build_peak_bytes", "launch_peak_bytes")
        if (v := getattr(exe, k, None))
    }
    if not peaks:
        return None
    return {**peaks, "peak_bytes": max(peaks.values())}
