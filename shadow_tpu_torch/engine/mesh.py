"""2-D mesh plane (port of shadow_tpu/engine/mesh.py): replicas x host
shards on one grid of logical devices.

The ensemble plane (engine/ensemble.py) runs R replicas as one batch on
one device; the sharded plane (engine/sharded.py) splits one world's
hosts over devices. The mesh composes them on a rows x shards grid:
replica rows spread over the grid's rows (R/rows replicas a row, as an
ensemble's rows view), and each row's hosts split over its shards. A
row's shards run the sharded engine's rounds (the window's reductions
and the exchange between its shards), per replica as the reference's
vmap gives them; rows never exchange. The driver is the ensemble
driver (run_ensemble_until: per-replica probe lines, quiescence
recording, checkpoint taps, the device-loss seams) with the grid's
chunk (engine/sharded.py GridChunk) and a capacity error that names
(replica, shard).

Exactness: replica r of a mesh run equals the reference's mesh run leaf
for leaf, and its state is init_ensemble_state's stack, so a mesh
checkpoint is an ensemble checkpoint and resumes on any grid.

The reference pins the dense exchange to all_gather on the mesh
(lax.all_to_all has no vmap batching rule); the segment exchange keeps
its ring. mesh_engine_cfg resolves the same way, so the configs agree.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from shadow_tpu_torch.config.options import parse_mesh  # noqa: F401
from shadow_tpu_torch.device import visible_devices
from shadow_tpu_torch.engine.ensemble import (
    _replica_capacity_error,
    ensemble_engine_cfg,
    init_ensemble_state,
    lower_ensemble_chunk,
    num_replicas,
    replica_seeds,
    replica_slice,
    run_ensemble_until,
)
from shadow_tpu_torch.engine.round import (
    PROBE_FIELDS,
    _capacity_error,
    effective_engine,
    validate_runahead,
)
from shadow_tpu_torch.engine.sharded import GridChunk, split_grid
from shadow_tpu_torch.engine.state import (
    EngineConfig,
    SimState,
    rows_view,
    stacked_view,
    trace_static_cfg,
)
from shadow_tpu_torch.utils.tree import tree_map

@dataclasses.dataclass(frozen=True)
class DeviceGrid:
    """The logical devices of a mesh, `devices` a [rows, shards] numpy
    array of LogicalDevice (the reference's jax.sharding.Mesh)."""

    devices: np.ndarray

    @property
    def shape(self) -> "tuple[int, int]":
        return tuple(self.devices.shape)

    @property
    def rows(self) -> "list[list]":
        return [list(r) for r in self.devices]

    @property
    def ids(self) -> "tuple[int, ...]":
        return tuple(int(d.id) for d in self.devices.ravel())


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """The 2-D decomposition of one [R, H, ...] batch: `rows x shards` is
    the device grid, `replicas` the batch's replica count (replicas/rows
    on each grid row). rows=1 is the pure sharded shape, shards=1 the
    pure ensemble shape, both through this one path."""

    replicas: int
    shards: int
    rows: int

    def __post_init__(self):
        if self.replicas < 1 or self.shards < 1 or self.rows < 1:
            raise ValueError("mesh replicas/shards/rows must all be >= 1")
        if self.replicas % self.rows:
            raise ValueError(
                f"mesh replicas={self.replicas} must be a multiple of the "
                f"replica-axis rows={self.rows} (each mesh row holds "
                "replicas/rows vmapped replicas)"
            )

    @property
    def devices_needed(self) -> int:
        return self.rows * self.shards

    @property
    def local_replicas(self) -> int:
        return self.replicas // self.rows

    def describe(self) -> str:
        return (
            f"{self.replicas} replica(s) x {self.shards} shard(s) on a "
            f"{self.rows}x{self.shards} Mesh(replica, hosts)"
        )

    def build_mesh(self, devices=None, device="cuda") -> DeviceGrid:
        """The grid over the first rows * shards of `devices` (default:
        the visible logical devices of `device`'s type)."""
        devices = list(devices if devices is not None else visible_devices(device))
        need = self.devices_needed
        if len(devices) < need:
            raise ValueError(
                f"mesh {self.rows}x{self.shards} needs {need} devices, "
                f"{len(devices)} visible"
            )
        grid = np.empty((self.rows, self.shards), dtype=object)
        for k, d in enumerate(devices[:need]):
            grid[k // self.shards, k % self.shards] = d
        return DeviceGrid(grid)

    @classmethod
    def for_batch(cls, replicas: int, rows: int, shards: int) -> "MeshPlan":
        """The plan for a batch of `replicas` jobs on a requested RxS
        grid: the rows degrade to the largest divisor of the batch size
        that fits (a one-job batch on 2x4 runs 1x4)."""
        rows_eff = max(
            (d for d in range(1, replicas + 1) if replicas % d == 0 and d <= rows),
            default=1,
        )
        return cls(replicas=replicas, shards=shards, rows=rows_eff)

    def degraded(self, devices_available: int, num_hosts: int) -> "MeshPlan | None":
        """The next rung after a device loss: the first smaller grid that
        fits the surviving device count and divides the host axis, in the
        order R x S/2 (halve the shards, every row intact), 1 x S, then
        1 x S/2 ... 1 x 1; each through for_batch. None when nothing is
        left below (the loss is terminal). Sound because the state is
        layout-free and every grid equals the reference's run."""
        cands: "list[tuple[int, int]]" = []
        if self.shards > 1:
            cands.append((self.rows, self.shards // 2))
        if self.rows > 1:
            cands.append((1, self.shards))
        s = self.shards // 2
        while s >= 1:
            cands.append((1, s))
            s //= 2
        for rows, shards in cands:
            if rows * shards >= self.devices_needed:
                continue  # a rung must shed devices, not rearrange them
            if num_hosts % shards:
                continue
            if rows * shards <= devices_available:
                return MeshPlan.for_batch(self.replicas, rows, shards)
        return None


def mesh_engine_cfg(cfg: EngineConfig) -> EngineConfig:
    """The engine config a mesh batch runs: the ensemble resolution plus
    the reference's exchange resolution (dense modes run all_gather,
    "segment" keeps its ring). The modes are trajectory-identical, so
    neither resolution changes a slice."""
    cfg = ensemble_engine_cfg(cfg)
    if cfg.exchange not in ("all_gather", "segment"):
        cfg = dataclasses.replace(cfg, exchange="all_gather")
    return cfg


def init_mesh_state(
    cfg: EngineConfig,
    model,
    plan: MeshPlan,
    seed_stride: int = 1,
    tx_bytes_per_interval=None,
    rx_bytes_per_interval=None,
    device="cuda",
) -> SimState:
    """The bootstrapped [R, ...] initial stack: init_ensemble_state's (the
    grid is applied at dispatch), so a mesh checkpoint template equals an
    ensemble one."""
    if cfg.num_hosts % plan.shards:
        raise ValueError(
            f"num_hosts={cfg.num_hosts} must divide evenly over "
            f"{plan.shards} host-shard(s)"
        )
    return init_ensemble_state(
        cfg, model, plan.replicas, seed_stride,
        tx_bytes_per_interval=tx_bytes_per_interval,
        rx_bytes_per_interval=rx_bytes_per_interval,
        device=device,
    )


def lower_mesh_chunk(st: SimState, end, rounds_per_chunk: int, model, tables,
                     cfg: EngineConfig, plan: MeshPlan, mesh: "DeviceGrid | None" = None
                     ) -> GridChunk:
    """The compile-cache seam, mesh variant: a GridChunk for this plan's
    grid under the canonical static cfg (worlds differing only in seed
    prepare one chunk), run_mesh_until's `launch`. On the card it loads
    the pump kernel's library (nvcc at first use) and checks a launch at
    one shard's shapes (engine/ensemble.py lower_ensemble_chunk). `end`
    keeps the reference's signature; the chunk takes the end time at
    each call."""
    cfg = trace_static_cfg(mesh_engine_cfg(cfg))
    validate_runahead(cfg, tables)
    if mesh is None:
        mesh = plan.build_mesh(device=st.device)
    # checked at one cell's shapes: the rows one shard of a grid row runs
    cell = split_grid(rows_view(st), [[d.physical for d in r] for r in mesh.rows])[0][0]
    probe = lower_ensemble_chunk(stacked_view(cell), end, rounds_per_chunk, model,
                                 tables.to(cell.device), cfg)
    chunk = GridChunk(model, cfg, rounds_per_chunk, mesh.rows, engine=probe.engine)
    chunk.instance, chunk.dynamic_smem = probe.instance, probe.dynamic_smem
    chunk.library_tag = probe.library_tag
    chunk.build_peak_bytes = probe.build_peak_bytes
    return chunk


def _mesh_capacity_detail(st: SimState, plan: MeshPlan) -> "list[dict]":
    """(replica, shard) overflow breakdown, fetched only on the failure
    path: the four counter grids as [R, S, local], naming each saturated
    cell with its overflow split and high-water marks."""
    s = plan.shards
    qov, oov, qhw, ohw = (
        t.detach().cpu().numpy().reshape(plan.replicas, s, -1)
        for t in (st.queue.overflow, st.outbox.overflow, st.tracker.queue_hwm,
                  st.tracker.outbox_hwm)
    )
    cells = []
    for r in range(plan.replicas):
        for j in range(s):
            if qov[r, j].sum() or oov[r, j].sum():
                cells.append({
                    "replica": r,
                    "shard": j,
                    "queue_overflow": int(qov[r, j].sum()),
                    "outbox_overflow": int(oov[r, j].sum()),
                    # hwm lanes accumulate only under cfg.tracker
                    "queue_hwm": int(qhw[r, j].max()),
                    "outbox_hwm": int(ohw[r, j].max()),
                })
    return cells


def mesh_capacity_error(rows: np.ndarray, st: SimState, plan: MeshPlan):
    """A CapacityError naming both mesh coordinates: the first saturated
    (replica, shard) cell of the replica the failing chunk's probe
    convicted, with its counter split and high-water marks, plus
    err.replica / err.shard / err.mesh_cells. `st` is the live state, one
    chunk past the failing one (the reference's pipelined driver has it
    in flight), whose counters can only over-count."""
    cells = _mesh_capacity_detail(st, plan)
    bad = np.nonzero(rows[:, PROBE_FIELDS.index("overflow")] > 0)[0]
    probe_r = int(bad[0]) if bad.size else None
    first = next((c for c in cells if c["replica"] == probe_r), cells[0] if cells else None)
    if first is None:
        err = _replica_capacity_error(rows)
        err.shard = None
        return err
    err = _capacity_error(
        sum(c["queue_overflow"] + c["outbox_overflow"] for c in cells),
        queue_ov=first["queue_overflow"],
        outbox_ov=first["outbox_overflow"],
        queue_hwm=first["queue_hwm"],
        outbox_hwm=first["outbox_hwm"],
    )
    err.replica = first["replica"]
    err.shard = first["shard"]
    err.mesh_cells = cells
    detail = f"(replica {first['replica']}, shard {first['shard']}) of {plan.replicas}x{plan.shards}"
    if len(cells) > 1:
        detail += f" (+{len(cells) - 1} more saturated cell(s))"
    err.args = (f"{err.args[0]} [{detail}]",)
    err._shard_detail = "; ".join(
        f"(r{c['replica']}, s{c['shard']}): queue_ov={c['queue_overflow']} "
        f"outbox_ov={c['outbox_overflow']}"
        + (f" queue_hwm={c['queue_hwm']} outbox_hwm={c['outbox_hwm']}"
           if c["queue_hwm"] or c["outbox_hwm"] else "")
        for c in cells
    )
    return err


def run_mesh_until(
    st: SimState,
    end_time: int,
    model,
    tables,
    cfg: EngineConfig,
    plan: MeshPlan,
    rounds_per_chunk: int = 64,
    max_chunks: int = 10_000,
    on_chunk=None,
    tracker=None,
    on_state=None,
    on_rows=None,
    launch=None,
    watchdog_s: float = 0.0,
    mesh: "DeviceGrid | None" = None,
    counters=None,
) -> SimState:
    """The 2-D mesh driver: chunks over the grid until every replica
    quiesces. `st` is an init_mesh_state [R, ...] stack (on the grid's
    first physical device), `cfg` the single-world config (resolved
    through mesh_engine_cfg). The driver is run_ensemble_until; only the
    chunk (GridChunk over `mesh`, by default plan.build_mesh() on the
    state's device type) and the capacity error's naming are the
    mesh's. `launch` takes a chunk lower_mesh_chunk prepared (the compile
    cache's entry) in place of one built here."""
    cfg = mesh_engine_cfg(cfg)
    validate_runahead(cfg, tables)
    r = num_replicas(st)  # loud on a non-batched state
    if r != plan.replicas:
        raise ValueError(f"state carries {r} replica(s), plan expects {plan.replicas}")
    if cfg.num_hosts % plan.shards:
        raise ValueError(
            f"num_hosts={cfg.num_hosts} must divide evenly over "
            f"{plan.shards} host-shard(s)"
        )
    if mesh is None:
        mesh = plan.build_mesh(device=st.device)
    if launch is None:
        launch = GridChunk(model, trace_static_cfg(cfg), rounds_per_chunk, mesh.rows,
                           engine=effective_engine(cfg, st.device))
    dev0 = mesh.rows[0][0].physical
    if st.device != dev0:
        st = tree_map(lambda x: x.to(dev0), st)

    def capacity_error(rows, live):
        return mesh_capacity_error(rows, live, plan)

    try:
        return run_ensemble_until(
            st, end_time, model, tables, cfg, rounds_per_chunk=rounds_per_chunk,
            max_chunks=max_chunks, on_chunk=on_chunk, counters=counters, on_rows=on_rows,
            on_state=on_state, tracker=tracker, watchdog_s=watchdog_s, launch=launch,
            capacity_error=capacity_error, devices=mesh.ids,
        )
    finally:
        launch.reset()


__all__ = [
    "DeviceGrid",
    "MeshPlan",
    "init_mesh_state",
    "lower_mesh_chunk",
    "mesh_capacity_error",
    "mesh_engine_cfg",
    "parse_mesh",
    "replica_seeds",
    "replica_slice",
    "run_mesh_until",
]
