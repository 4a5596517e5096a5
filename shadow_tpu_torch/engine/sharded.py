"""Multi-device execution: hosts block-sharded over logical devices (port
of shadow_tpu/engine/sharded.py).

The reference shards every [H, ...] leaf of its state over a device
mesh and runs its round engine under shard_map; each device drains its
hosts' events on its own within the conservative window, and the only
cross-device traffic of a round is the window's pmin and the outbox
exchange (all_to_all buckets, an all_gather, or the segment exchange's
ppermute ring). Here one controller drives S shard states, shard j's
tensors on logical device j (device.py): each round reduces the shards'
window candidates, drains every shard with its own loop (on the card,
the pump kernel launches once per shard per drain iteration, on that
shard's rows), and moves the exchange's buckets between the shards
with `.to(device)` (engine/round.py ShardContext). There is no
torch.distributed and no process per device: checkpoints, recovery
snapshots and a device-loss replay need the whole state, which the one
controller has.

The driver is engine/round.py's run_until with this module's chunk
(GridChunk) and per-shard capacity detail. Between chunks the driver
holds the state merged on the first shard's device, the layout the
reference's driver reads through its probe and its host fetches; the
shard states carry over to the next chunk when the driver hands back
the state it was given, so a shard's own scalar leaves persist as the
reference's per-device copies do (a replicated output of shard_map is
read from its first device, while each device keeps its own).
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch import equeue
from shadow_tpu_torch.engine.round import (
    ShardContext,
    _next_window_end,
    _replace,
    capacity_topk,
    run_round,
    run_until,
    validate_runahead,
)
from shadow_tpu_torch.engine.state import (
    WORLD_LEAVES,
    EngineConfig,
    SimState,
    per_replica,
    replicas_of,
)
from shadow_tpu_torch.graph.routing import RoutingTables


def auto_a2a_capacity(
    cfg: EngineConfig,
    num_devices: int,
    safety: int = 4,
    measured_hwm: "int | None" = None,
) -> int:
    """The per-peer exchange bucket (all_to_all buckets, the segment
    ring's buckets) for a2a_capacity == 0, rather than the whole local
    outbox. Overflow is counted and fails loudly (CapacityError), so a
    bucket that is too small is an error, never a silent loss. With
    `measured_hwm` (a prior run's per-round exchange high-water,
    ChunkProbe.exch_hwm under cfg.tracker) the bucket is that plus 25%;
    without it, each peer is taken to see about 1/num_devices of a
    shard's outbox, `safety` times over."""
    local_m = max(1, (cfg.num_hosts // num_devices) * cfg.outbox_capacity)
    if measured_hwm is not None and measured_hwm > 0:
        margin = -(-int(measured_hwm) // 4)  # ceil(25%)
        return min(local_m, max(1, int(measured_hwm) + margin))
    return min(local_m, max(1, -(-safety * local_m // num_devices)))


def _map_paths(fn, tree, *rest, prefix=""):
    """fn(path, leaf, *leaves of `rest` at that path) over every tensor
    leaf of a state (None leaves stay None)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_paths(fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest),
                               prefix=f"{prefix}.{f.name}")
            for f in dataclasses.fields(tree)
        })
    if tree is None:
        return None
    return fn(prefix, tree, *rest)


def split_grid(st: SimState, grid: "list[list[torch.device]]") -> "list[list[SimState]]":
    """A world's state (or an ensemble's rows view) cut into a grid of
    shard states, one per (row, shard) of `grid`: row i takes replicas
    i * R/rows .. (i + 1) * R/rows - 1 (a single world is one row), shard
    j its hosts j * H/S .. (j + 1) * H/S - 1, as rows of that row's
    replicas (an ensemble rows view itself), each on grid[i][j]. Every
    cell owns its tensors (the kernel updates them in place)."""
    worlds = replicas_of(st)
    w = worlds or 1
    rows, shards = len(grid), len(grid[0])
    rl, h = w // rows, st.num_hosts // w
    hl = h // shards

    def cell(i, j):
        dev = grid[i][j]

        def take(path, x):
            if path in WORLD_LEAVES:
                y = x if worlds is None else x[i * rl:(i + 1) * rl]
                return y.to(dev, copy=True)
            y = x.reshape((w, h) + tuple(x.shape[1:]))[i * rl:(i + 1) * rl, j * hl:(j + 1) * hl]
            return y.reshape((-1,) + tuple(x.shape[1:])).to(dev, copy=True)

        return _map_paths(take, st)

    return [[cell(i, j) for j in range(shards)] for i in range(rows)]


def merge_grid(cells: "list[list[SimState]]", device) -> SimState:
    """Inverse of split_grid, on `device`. A world leaf comes from each
    row's first shard, as the reference's replicated outputs are read
    from the first device of their mesh row."""
    rows, shards = len(cells), len(cells[0])
    flat = [c for row in cells for c in row]
    worlds = replicas_of(flat[0])

    def join(path, *xs):
        if path in WORLD_LEAVES:
            if worlds is None:
                return xs[0].to(device, copy=True)
            return torch.cat([xs[i * shards].to(device) for i in range(rows)])
        tail = tuple(xs[0].shape[1:])
        rl = worlds or 1
        parts = [x.to(device).reshape((rl, -1) + tail) for x in xs]
        row_t = [torch.cat(parts[i * shards:(i + 1) * shards], dim=1) for i in range(rows)]
        return torch.cat(row_t, dim=0).reshape((-1,) + tail)

    return _map_paths(join, flat[0], *flat[1:])


def _world_min_next(c: SimState):
    nt = equeue.next_time(c.queue)
    return nt.amin() if replicas_of(c) is None else per_replica(c, nt).amin(dim=1)


def _world_has_traffic(c: SimState):
    v = c.outbox.valid
    return v.any() if replicas_of(c) is None else per_replica(c, v).any(dim=1)


def shard_rounds(cells: "list[SimState]", shards: ShardContext, tables: list, end_time: int,
                 model, cfg: EngineConfig, rounds_per_chunk: int,
                 counters=None) -> "list[SimState]":
    """`rounds_per_chunk` rounds over one world's shards (or one mesh
    row's): engine/round.py's chunk loop (_run_chunk, or an ensemble's
    EnsembleChunk) with the window's start, traffic, least latency and
    lookahead bound reduced over the shards and the exchange between
    them. Once no shard has work before end_time and no packet is
    staged (per replica on an ensemble's rows), the round and every
    later one of the chunk take the idle branch."""
    ensemble = replicas_of(cells[0]) is not None
    end_t = torch.tensor(end_time, dtype=torch.int64, device=shards.devices[0])
    for k in range(rounds_per_chunk):
        start = shards.pmin([_world_min_next(c) for c in cells])
        has_traffic = shards.pany([_world_has_traffic(c) for c in cells])
        window_end = _next_window_end(cells, end_time, cfg, start, tables, shards)
        live = (start < end_t) | has_traffic
        if not bool(live.any()):
            idle = rounds_per_chunk - k
            ends = shards.scatter(window_end)
            cells = [_replace(c, now=torch.maximum(c.now, ends[j])) for j, c in enumerate(cells)]
            if cfg.tracker:
                cells = [_replace(c, tracker=_replace(
                    c.tracker, rounds_idle=c.tracker.rounds_idle + idle)) for c in cells]
            break
        width = window_end - torch.minimum(start, window_end)
        if ensemble:
            width = torch.where(live, width, 0)
        widths = shards.scatter(width)
        cells = [_replace(c, win_ns_sum=c.win_ns_sum + widths[j]) for j, c in enumerate(cells)]
        cells = run_round(cells, window_end, model, tables, cfg, counters,
                          live=live if ensemble else None, shards=shards)
        if cfg.tracker:
            lives = shards.scatter(live.to(torch.int64))
            cells = [_replace(c, tracker=_replace(
                c.tracker, rounds_live=c.tracker.rounds_live + lives[j],
                rounds_idle=c.tracker.rounds_idle + (1 - lives[j]))) for j, c in enumerate(cells)]
    return cells


class GridChunk:
    """One chunk of `rounds_per_chunk` rounds on a grid of logical devices
    (`grid`: rows of LogicalDevice, every row of one length): each row's
    shards run shard_rounds, the rows on their own (replicas never
    exchange). Called as `chunk(st, end_time, tables, counters=None)` on
    the merged state (a world, or an ensemble's rows view) and returns
    the merged state after the chunk, on the first device's physical
    device: the `chunk` of run_until and the `launch` of
    run_ensemble_until. When called with the state it returned last, it
    continues from its own shard states."""

    def __init__(self, model, cfg: EngineConfig, rounds_per_chunk: int, grid, engine: str = ""):
        self.model = model
        self.cfg = cfg
        self.rounds_per_chunk = int(rounds_per_chunk)
        self.grid = [list(row) for row in grid]
        self.engine = engine
        # what lower_mesh_chunk records of a chunk it prepared (the
        # kernel's instance, dynamic shared memory, library digest and
        # the allocator's peaks), as an EnsembleChunk carries them
        self.instance = self.dynamic_smem = self.library_tag = None
        self.build_peak_bytes = self.launch_peak_bytes = None
        self._carry = None  # (the merged state returned last, its shard states)
        self._tables = (None, {})  # (the tables given last, {device: their copy there})

    def reset(self) -> None:
        """Drop the shard states and tables of the last call (a chunk kept
        by the compile cache must not hold a finished batch's tensors)."""
        self._carry = None
        self._tables = (None, {})

    @property
    def physical(self) -> "list[list[torch.device]]":
        return [[d.physical for d in row] for row in self.grid]

    def _tables_on(self, tables: RoutingTables, dev: torch.device) -> RoutingTables:
        if self._tables[0] is not tables:
            self._tables = (tables, {})
        copies = self._tables[1]
        if dev not in copies:
            copies[dev] = tables.to(dev)
        return copies[dev]

    def __call__(self, st: SimState, end_time: int, tables: RoutingTables, counters=None):
        carry = self._carry
        phys = self.physical
        cells = carry[1] if carry is not None and carry[0] is st else split_grid(st, phys)
        hl = cells[0][0].num_hosts // (replicas_of(cells[0][0]) or 1)
        out = []
        for row, devs in zip(cells, phys):
            shards = ShardContext(tuple(devs), hl)
            tl = [self._tables_on(tables, d) for d in devs]
            out.append(shard_rounds(row, shards, tl, end_time, self.model, self.cfg,
                                    self.rounds_per_chunk, counters))
        merged = merge_grid(out, phys[0][0])
        self._carry = (merged, out)
        return merged


class ShardedRunner:
    """The sharded simulation driver for one (devices, model, cfg): the
    world's hosts block-sharded over `devices` (LogicalDevice, device.py
    visible_devices)."""

    def __init__(
        self,
        devices,
        model,
        tables: RoutingTables,
        cfg: EngineConfig,
        rounds_per_chunk: int = 64,
        measured_exchange_hwm: "int | None" = None,
    ):
        self.devices = list(devices)
        n = len(self.devices)
        if cfg.num_hosts % n != 0:
            raise ValueError(
                f"num_hosts={cfg.num_hosts} must divide evenly over "
                f"{n} devices on axis 'hosts'"
            )
        validate_runahead(cfg, tables)
        if cfg.exchange in ("all_to_all", "dense", "segment") and cfg.a2a_capacity == 0:
            # a2a_capacity == 0 asks for the auto bucket: measured from a
            # prior run's per-round traffic when given, else the topology
            # heuristic; an undersized bucket is a loud CapacityError
            # (a2a_capacity=-1: whole-outbox buckets, never overflowing)
            cfg = dataclasses.replace(
                cfg, a2a_capacity=auto_a2a_capacity(cfg, n, measured_hwm=measured_exchange_hwm))
        self.model = model
        self.tables = tables
        self.cfg = cfg
        self.rounds_per_chunk = rounds_per_chunk

    @property
    def num_devices(self) -> int:
        return len(self.devices)

    def _capacity_detail(self, st: SimState) -> str:
        """The per-shard overflow breakdown of a CapacityError (the probe
        says that capacity blew, not where): the four [H] counters as
        [shards, local], naming each shard that saturated, then
        capacity_topk's landing-side view."""
        n = self.num_devices
        qov, oov, qhw, ohw = (
            t.detach().cpu().numpy().reshape(n, -1)
            for t in (st.queue.overflow, st.outbox.overflow, st.tracker.queue_hwm,
                      st.tracker.outbox_hwm)
        )
        rows = []
        for i in range(n):
            if qov[i].sum() or oov[i].sum():
                row = f"shard {i}: queue_ov={int(qov[i].sum())} outbox_ov={int(oov[i].sum())}"
                # high-water marks accumulate only under cfg.tracker
                if qhw[i].max() or ohw[i].max():
                    row += f" queue_hwm={int(qhw[i].max())} outbox_hwm={int(ohw[i].max())}"
                rows.append(row)
        detail = "per-shard overflow: " + "; ".join(rows) if rows else ""
        topk = capacity_topk(st)
        if topk:
            detail = f"{detail}\n{topk}" if detail else topk
        return detail

    def run_until(
        self,
        st: SimState,
        end_time: int,
        max_chunks: int = 10_000,
        on_chunk=None,
        tracker=None,
        on_state=None,
        watchdog_s: float = 0.0,
        counters=None,
    ) -> SimState:
        """engine/round.py run_until with the sharded chunk: the same
        probe-per-chunk loop, state taps, heartbeats, watchdog and chaos
        seams, and the per-shard capacity detail. The returned state is
        merged on the first device."""
        return run_until(
            st, end_time, self.model, self.tables, self.cfg,
            rounds_per_chunk=self.rounds_per_chunk, max_chunks=max_chunks,
            on_chunk=on_chunk, counters=counters, on_state=on_state, tracker=tracker,
            watchdog_s=watchdog_s,
            chunk=GridChunk(self.model, self.cfg, self.rounds_per_chunk, [self.devices]),
            capacity_detail=self._capacity_detail,
        )


__all__ = [
    "GridChunk",
    "ShardedRunner",
    "auto_a2a_capacity",
    "merge_grid",
    "shard_rounds",
    "split_grid",
]

