"""Simulation state: hosts as rows of device-resident tensors (port of
shadow_tpu/engine/state.py).

The state is a dataclass of tensors whose field paths mirror the
reference's flax pytree, so `state_to_numpy` / `state_from_numpy` map a
port state to and from a dict of numpy arrays keyed exactly like
`jax.tree_util.keystr` keys the reference's SimState leaves. u32 leaves
(seq, rng_counter, the threefry key words) cross as uint32 and live here
as int64 tensors holding values in [0, 2**32).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from shadow_tpu_torch import equeue, netstack, rng
from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.equeue import PAYLOAD_LANES, EventQueue
from shadow_tpu_torch.events import MAX_HOSTS
from shadow_tpu_torch.netstack import NetDevState
from shadow_tpu_torch.simtime import TIME_MAX
from shadow_tpu_torch.utils.tree import tree_leaves_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine parameters: the reference's EngineConfig field for
    field (shadow_tpu/engine/state.py documents each), so one config maps
    onto both packages. The port reads all of them but megakernel_tile, a
    TPU-tiling knob with no effect here (a2a_capacity sizes the sharded
    exchange's buckets, engine/sharded.py), and ensemble (set by
    engine/ensemble.py), which changes nothing: the engine reads the
    replica count from the state's shapes. engine:
    "auto" (the megakernel on the card, else pump when pump_k > 0, else
    plain), "plain", "pump" or "megakernel" (the CUDA kernel on the card,
    its twin on the CPU) — all bit-identical."""

    num_hosts: int
    queue_capacity: int = 64
    outbox_capacity: int = 16
    runahead_ns: int = 1_000_000
    seed: int = 1
    max_iters_per_round: int = 1_000_000
    use_netstack: bool = False
    bootstrap_end_ns: int = 0
    use_dynamic_runahead: bool = False
    adaptive_window: bool = True
    exchange: str = "all_to_all"
    a2a_capacity: int = -1
    pool_capacity: int = 0
    deliver_lanes: int = 0
    active_lanes: int = 0
    pump_k: int = 0
    engine: str = "auto"
    megakernel_tile: int = 0
    tracker: bool = False
    ensemble: bool = False

    def __post_init__(self):
        if not 0 < self.num_hosts <= MAX_HOSTS:
            raise ValueError(f"num_hosts must be in (0, {MAX_HOSTS}]")
        if self.runahead_ns <= 0:
            raise ValueError("runahead must be > 0")
        if self.engine not in ("auto", "plain", "pump", "megakernel"):
            raise ValueError(
                f"unknown engine {self.engine!r} "
                "(expected 'auto', 'plain', 'pump', or 'megakernel')"
            )
        if self.exchange not in ("all_to_all", "all_gather", "dense", "segment"):
            raise ValueError(
                f"unknown exchange {self.exchange!r} (expected 'all_to_all', "
                "'all_gather', 'dense', or 'segment')"
            )
        if self.pool_capacity < 0:
            raise ValueError("pool_capacity must be >= 0 (0 = whole outbox)")
        if self.engine == "pump" and self.pump_k <= 0:
            raise ValueError("engine='pump' requires pump_k > 0")
        if self.megakernel_tile < 0 or (
            self.megakernel_tile > 0 and self.num_hosts % self.megakernel_tile
        ):
            raise ValueError("megakernel_tile must be 0 or divide num_hosts")
        if (
            0 < self.active_lanes
            and self.megakernel_tile > 0
            and self.active_lanes % self.megakernel_tile
        ):
            # compacted iterations hand the megakernel an active_lanes-row
            # sub-state; an explicit tile must divide that too
            raise ValueError(
                "megakernel_tile must divide active_lanes when both are set"
            )


def trace_static_cfg(cfg: EngineConfig) -> EngineConfig:
    """`cfg` with every field that cannot change what a chunk computes
    canonicalized: the seed (it enters the state only through the key
    grid built at init) goes to 0, and "dense", an alias, to
    "all_to_all". The reference keys its compiled chunk programs and the
    autotuner's probe cache by it (runtime/autotune.py); its repr is the
    reference's, field for field."""
    exchange = "all_to_all" if cfg.exchange == "dense" else cfg.exchange
    return dataclasses.replace(cfg, seed=0, exchange=exchange)


@dataclasses.dataclass
class Outbox:
    """Per-host staging area for packets emitted during a round; rows are
    owned by the emitting host, and the round-boundary flush lands them."""

    valid: torch.Tensor  # [H, O] bool
    dst: torch.Tensor  # [H, O] i32
    time: torch.Tensor  # [H, O] i64 delivery time
    tie: torch.Tensor  # [H, O] i64
    data: torch.Tensor  # [H, O, PAYLOAD_LANES] i32
    aux: torch.Tensor  # [H, O] i32 (packet size in bytes)
    fill: torch.Tensor  # [H] i32 next free lane
    overflow: torch.Tensor  # [H] i32 emissions dropped for lack of lanes


def _empty_outbox(h: int, o: int, device) -> Outbox:
    return Outbox(
        valid=torch.zeros((h, o), dtype=torch.bool, device=device),
        dst=torch.zeros((h, o), dtype=torch.int32, device=device),
        time=torch.full((h, o), TIME_MAX, dtype=torch.int64, device=device),
        tie=torch.zeros((h, o), dtype=torch.int64, device=device),
        data=torch.zeros((h, o, PAYLOAD_LANES), dtype=torch.int32, device=device),
        aux=torch.zeros((h, o), dtype=torch.int32, device=device),
        fill=torch.zeros((h,), dtype=torch.int32, device=device),
        overflow=torch.zeros((h,), dtype=torch.int32, device=device),
    )


@dataclasses.dataclass
class TrackerState:
    """Device-side observability counters (the tracker plane); written by
    the engines when EngineConfig.tracker is set, never read back by the
    simulation."""

    ev_local: torch.Tensor  # [H] i64
    ev_tcp: torch.Tensor  # [H] i64
    bytes_ctrl: torch.Tensor  # [H] i64
    bytes_data: torch.Tensor  # [H] i64
    retrans_segs: torch.Tensor  # [H] i64
    queue_hwm: torch.Tensor  # [H] i32
    outbox_hwm: torch.Tensor  # [H] i32
    rounds_live: torch.Tensor  # scalar i64
    rounds_idle: torch.Tensor  # scalar i64
    exch_hwm: torch.Tensor  # [H] i32 (row 0 carries the value)


def _empty_tracker(h: int, device) -> TrackerState:
    def z(dt):
        return torch.zeros((h,), dtype=dt, device=device)

    scalar = torch.zeros((), dtype=torch.int64, device=device)
    return TrackerState(
        ev_local=z(torch.int64),
        ev_tcp=z(torch.int64),
        bytes_ctrl=z(torch.int64),
        bytes_data=z(torch.int64),
        retrans_segs=z(torch.int64),
        queue_hwm=z(torch.int32),
        outbox_hwm=z(torch.int32),
        rounds_live=scalar.clone(),
        rounds_idle=scalar.clone(),
        exch_hwm=z(torch.int32),
    )


@dataclasses.dataclass
class SimState:
    now: torch.Tensor  # scalar i64: start of the current window
    min_used_lat: torch.Tensor  # scalar i64
    queue: EventQueue
    outbox: Outbox
    seq: torch.Tensor  # [H] u32 (held in i64)
    rng_key: torch.Tensor  # [H, 2] u32 key words (held in i64)
    rng_counter: torch.Tensor  # [H] u32 (held in i64)
    host_id: torch.Tensor  # [H] i32
    net: NetDevState
    model: Any
    events_handled: torch.Tensor  # [H] i64
    packets_sent: torch.Tensor  # [H] i64
    packets_dropped: torch.Tensor  # [H] i64
    packets_unroutable: torch.Tensor  # [H] i64
    iters_done: torch.Tensor  # [H] i32 (row 0 carries the count)
    lanes_live: torch.Tensor  # [H] i64
    win_ns_sum: torch.Tensor  # scalar i64
    tracker: TrackerState

    @property
    def num_hosts(self) -> int:
        return self.seq.shape[0]

    @property
    def device(self) -> torch.device:
        return self.seq.device

    def clone(self) -> "SimState":
        """A private deep copy (callers that compare two paths clone
        first: the megakernel updates its state in place)."""
        return tree_map(torch.clone, self)


@dataclasses.dataclass
class LocalEmits:
    """Up to EL local (task/timer) events per host from one handler call."""

    valid: torch.Tensor  # [H, EL] bool
    time: torch.Tensor  # [H, EL] i64
    kind: torch.Tensor  # [H, EL] i32
    data: torch.Tensor  # [H, EL, PAYLOAD_LANES] i32


@dataclasses.dataclass
class PacketEmits:
    """Up to EP packets per host from one handler call."""

    valid: torch.Tensor  # [H, EP] bool
    dst: torch.Tensor  # [H, EP] i32
    data: torch.Tensor  # [H, EP, PAYLOAD_LANES] i32
    size: torch.Tensor  # [H, EP] i32


# Leaves that hold one value per world; every other leaf holds one row per
# host. An ensemble state stacks R worlds: its per-world leaves are [R]
# and its per-host leaves [R, H, ...] (the reference's stacked layout),
# which the engine computes on as [R * H, ...] rows (rows_view).
WORLD_LEAVES = frozenset(
    (".now", ".min_used_lat", ".win_ns_sum", ".tracker.rounds_live", ".tracker.rounds_idle")
)


def replicas_of(st) -> "int | None":
    """R of an ensemble state (its per-world leaves are [R]); None for a
    single world."""
    return None if st.now.ndim == 0 else int(st.now.shape[0])


def per_row(st, x):
    """A per-world value as the engine's rows see it: unchanged for a
    single world; an ensemble's [R] value repeated for each replica's H
    rows (on its rows view)."""
    r = replicas_of(st)
    if r is None:
        return x
    return x.repeat_interleave(st.num_hosts // r)


def per_replica(st, x: torch.Tensor) -> torch.Tensor:
    """Row tensor x of an ensemble ([R * H, ...], or stacked [R, H, ...])
    as [R, H * ...]: one line per replica, so that per-replica
    reductions run along dim 1."""
    return x.reshape(replicas_of(st), -1)


def map_host_leaves(fn, tree, *rest, prefix=""):
    """fn over the per-host leaves of one state (or, leaf by leaf, of
    several states of one shape); each per-world leaf is taken from the
    last state given."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_host_leaves(fn, getattr(tree, f.name),
                                    *(getattr(r, f.name) for r in rest),
                                    prefix=f"{prefix}.{f.name}")
            for f in dataclasses.fields(tree)
        })
    if tree is None or prefix in WORLD_LEAVES:
        return rest[-1] if rest else tree
    return fn(tree, *rest)


def rows_view(st: SimState) -> SimState:
    """An ensemble state with its per-host leaves viewed as [R * H, ...]
    rows (no copy; replica r owns rows r*H .. r*H + H - 1). The engine
    computes on this view: the handler, the exchange and the kernel see
    rows, and `host_id` stays each host's id within its replica."""
    return map_host_leaves(lambda x: x.reshape((-1,) + tuple(x.shape[2:])), st)


def stacked_view(st: SimState) -> SimState:
    """Inverse of rows_view: per-host leaves back to [R, H, ...]."""
    r = replicas_of(st)
    return map_host_leaves(lambda x: x.reshape((r, -1) + tuple(x.shape[1:])), st)


def init_state(
    cfg: EngineConfig,
    model_state,
    tx_bytes_per_interval=None,
    rx_bytes_per_interval=None,
    device="cuda",
) -> SimState:
    """Build the initial state on `device` (the card unless asked for the
    CPU). `model_state` must already live there (model.init(device))."""
    dev = resolve_device(device)
    h = cfg.num_hosts

    def z(dt):
        return torch.zeros((h,), dtype=dt, device=dev)

    return SimState(
        now=torch.zeros((), dtype=torch.int64, device=dev),
        min_used_lat=torch.full((), TIME_MAX, dtype=torch.int64, device=dev),
        queue=equeue.create(h, cfg.queue_capacity, dev),
        outbox=_empty_outbox(h, cfg.outbox_capacity, dev),
        seq=z(torch.int64),
        rng_key=rng.host_keys(cfg.seed, h, dev),
        rng_counter=z(torch.int64),
        host_id=torch.arange(h, dtype=torch.int32, device=dev),
        net=netstack.create(h, tx_bytes_per_interval, rx_bytes_per_interval, dev),
        model=model_state,
        events_handled=z(torch.int64),
        packets_sent=z(torch.int64),
        packets_dropped=z(torch.int64),
        packets_unroutable=z(torch.int64),
        iters_done=z(torch.int32),
        lanes_live=z(torch.int64),
        win_ns_sum=torch.zeros((), dtype=torch.int64, device=dev),
        tracker=_empty_tracker(h, dev),
    )


# leaves that the reference keeps as uint32 (the port holds them in i64)
_U32_LEAVES = (".seq", ".rng_counter", ".rng_key")


def state_to_numpy(st) -> "dict[str, np.ndarray]":
    """{reference leaf path: numpy array} with the reference's dtypes:
    the port's form of the weights carried across (rng_key crosses as
    jax.random.key_data, u32 [H, 2])."""
    out = {}
    for path, leaf in tree_leaves_with_path(st):
        a = leaf.detach().cpu().numpy()
        if path in _U32_LEAVES:
            a = a.astype(np.uint32)
        out[path] = a
    return out


def _model_state_classes():
    from shadow_tpu_torch.models.bulk import BulkState
    from shadow_tpu_torch.models.overlay.cdn import CdnState
    from shadow_tpu_torch.models.overlay.gossip import GossipState
    from shadow_tpu_torch.models.overlay.onion import OnionState
    from shadow_tpu_torch.models.phold import PholdState
    from shadow_tpu_torch.models.tgen import TgenState

    return (TgenState, PholdState, BulkState, OnionState, CdnState, GossipState)


def _model_template(leaves: dict):
    """The model-state dataclass (of None leaves) whose leaf paths are
    exactly the `.model.*` paths of a leaf dict."""
    from shadow_tpu_torch.transport.tcp import TcpState

    want = {p for p in leaves if p.startswith(".model.")}
    tcp_paths = {f".model.tcp.{f.name}" for f in dataclasses.fields(TcpState)}
    for cls in _model_state_classes():
        names = [f.name for f in dataclasses.fields(cls)]
        paths = {f".model.{n}" for n in names if n != "tcp"}
        if "tcp" in names:
            paths |= tcp_paths
        if paths == want:
            sub = {n: None for n in names}
            if "tcp" in names:
                sub["tcp"] = TcpState(**{f.name: None for f in dataclasses.fields(TcpState)})
            return cls(**sub)
    raise ValueError(f"state_from_numpy: no model state has the leaves {sorted(want)}")


def _skeleton(device):
    """A SimState of None leaves, for state_from_numpy to fill."""

    def empty(cls, **sub):
        return cls(
            **{f.name: sub.get(f.name) for f in dataclasses.fields(cls)}
        )

    return empty(
        SimState,
        queue=empty(EventQueue),
        outbox=empty(Outbox),
        net=empty(NetDevState),
        tracker=empty(TrackerState),
    )


def state_from_numpy(leaves: dict, device="cpu") -> SimState:
    """Inverse of state_to_numpy: build a port SimState on `device` from
    {reference leaf path: array}, for a world of any ported model (the
    model state is the one whose leaves the dict holds)."""
    dev = torch.device(device)
    like = _skeleton(dev)
    like.model = _model_template(leaves)
    paths = [p for p, _ in _paths_of(like)]
    missing = sorted(set(paths) - set(leaves))
    if missing:
        raise ValueError(f"state_from_numpy: missing leaves {missing}")

    def build(node, prefix):
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(
                node,
                **{
                    f.name: build(getattr(node, f.name), f"{prefix}.{f.name}")
                    for f in dataclasses.fields(node)
                },
            )
        a = np.asarray(leaves[prefix])
        if prefix in _U32_LEAVES:
            a = a.astype(np.int64)
        return torch.as_tensor(np.array(a, order="C"), device=dev)

    return build(like, "")


def _paths_of(tree, prefix=""):
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = []
        for f in dataclasses.fields(tree):
            out += _paths_of(getattr(tree, f.name), f"{prefix}.{f.name}")
        return out
    return [(prefix, tree)]


def leaf_nbytes(leaf) -> int:
    """Device bytes of one tensor leaf (shape x element size)."""
    return int(leaf.numel()) * leaf.element_size()


def tree_nbytes(tree) -> int:
    """Sum of leaf_nbytes over a state (or any sub-tree of one)."""
    return sum(leaf_nbytes(leaf) for _, leaf in tree_leaves_with_path(tree))


def snapshot_nbytes(tree) -> int:
    """Bytes of a state (or any sub-tree of one) in its host snapshot's
    layout, state_to_host's: u32 leaves at 4 bytes, every other leaf at
    its tensor's width. This is the reference's pricing of the same
    state (its u32 leaves are 4 bytes on the device too)."""
    total = 0
    for path, leaf in tree_leaves_with_path(tree):
        width = 4 if path in _U32_LEAVES else leaf.element_size()
        total += int(leaf.numel()) * width
    return total


def buffer_nbytes(sub, base_ndim: int, scale: float = 1.0) -> int:
    """Priced bytes of a capacity-indexed buffer sub-tree (queue/outbox).
    Leaves with more axes than `base_ndim` (the rank of the per-host
    counters, e.g. queue.count) carry the capacity axis and scale
    linearly with it, so scale=new/old projects a regrow without
    allocating."""
    total = 0
    for _, leaf in tree_leaves_with_path(sub):
        b = leaf_nbytes(leaf)
        if scale != 1.0 and leaf.dim() > base_ndim:
            b = int(b * scale)
        total += b
    return int(total)


def price_regrow(st, queue_capacity=None, outbox_capacity=None) -> int:
    """Projected snapshot_nbytes of `st` after grow_state (or
    grow_ensemble_state) to the given capacities, priced from the current
    shapes without allocating: the capacity axis scales every
    [.., C(, lanes)] grid linearly and nothing else."""
    q, ob = st.queue, st.outbox
    total = snapshot_nbytes(st)
    if queue_capacity is not None:
        old = int(q.time.shape[-1])
        if queue_capacity != old:
            base = q.count.dim()
            total += buffer_nbytes(q, base, queue_capacity / old) - buffer_nbytes(q, base)
    if outbox_capacity is not None:
        old = int(ob.valid.shape[-1])
        if outbox_capacity != old:
            base = ob.fill.dim()
            total += buffer_nbytes(ob, base, outbox_capacity / old) - buffer_nbytes(ob, base)
    return int(total)


def fmt_bytes(n: "int | float") -> str:
    """Human-readable bytes for error messages."""
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.0f} {unit}" if unit == "B" else f"{n:.2f} {unit}"
        n /= 1024
    return f"{n:.2f} GiB"


def _grow(st: SimState, queue_capacity, outbox_capacity, axis: int) -> SimState:
    """grow_state along capacity axis `axis` (1 for one world's [H, C]
    buffers, 2 for an ensemble's [R, H, C])."""
    from shadow_tpu_torch.events import KIND_INVALID

    def pad(a, extra, fill):
        shape = list(a.shape)
        shape[axis] = extra
        return torch.cat([a, torch.full(shape, fill, dtype=a.dtype, device=a.device)], dim=axis)

    q = st.queue
    cap = q.time.shape[axis]
    if queue_capacity is not None and queue_capacity != cap:
        if queue_capacity < cap:
            raise ValueError("grow_state cannot shrink queue_capacity")
        extra = queue_capacity - cap
        q = dataclasses.replace(
            q,
            time=pad(q.time, extra, TIME_MAX),
            tie=pad(q.tie, extra, equeue.I64_MAX),
            kind=pad(q.kind, extra, KIND_INVALID),
            data=pad(q.data, extra, 0),
            aux=pad(q.aux, extra, 0),
        )
    ob = st.outbox
    o_cap = ob.valid.shape[axis]
    if outbox_capacity is not None and outbox_capacity != o_cap:
        if outbox_capacity < o_cap:
            raise ValueError("grow_state cannot shrink outbox_capacity")
        extra = outbox_capacity - o_cap
        ob = dataclasses.replace(
            ob,
            valid=pad(ob.valid, extra, False),
            dst=pad(ob.dst, extra, 0),
            time=pad(ob.time, extra, TIME_MAX),
            tie=pad(ob.tie, extra, 0),
            data=pad(ob.data, extra, 0),
            aux=pad(ob.aux, extra, 0),
        )
    return dataclasses.replace(st, queue=q, outbox=ob)


def grow_state(
    st: SimState,
    queue_capacity: "int | None" = None,
    outbox_capacity: "int | None" = None,
) -> SimState:
    """Widen the fixed-slot buffers of a state in place of a fresh init:
    existing slots keep their contents (including tombstone garbage,
    identical on matched trajectories, so leaf-exactness survives), new
    slots get the canonical empty fill values of equeue.create /
    _empty_outbox. Growing is trajectory-neutral for a state that never
    overflowed: a run continued from the grown state is leaf-exact to one
    that started with the larger capacity, which is what makes
    rollback-and-regrow recovery deterministic. Shrinking is refused: it
    could drop live slots."""
    return _grow(st, queue_capacity, outbox_capacity, axis=1)


def state_to_host(st: SimState) -> "dict[str, np.ndarray]":
    """The host snapshot of a state: {reference leaf path: numpy array}
    in the reference's leaf order and dtypes (state_to_numpy), each array
    owning its memory, so that later writes to the state's tensors (the
    kernel updates them in place) cannot change it. Shared by checkpoint
    files (runtime/checkpoint.py) and the rollback point of capacity
    recovery (runtime/recovery.py). Invert with state_from_host."""
    return {k: np.array(v, copy=True) for k, v in state_to_numpy(st).items()}


def state_from_host(host: "dict[str, np.ndarray]", like: SimState) -> SimState:
    """Rebuild a state on `like`'s device from a state_to_host snapshot.
    `like` is the template (a state of the same world and config): every
    leaf must have its shape, and takes its dtype; a shape drift means
    the snapshot belongs to a different world or config."""

    def build(node, prefix):
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name), f"{prefix}.{f.name}")
                for f in dataclasses.fields(node)
            })
        if node is None:
            return None
        if prefix not in host:
            raise ValueError(
                f"snapshot has no leaf {prefix}; it was taken for a different world/config")
        a = np.asarray(host[prefix])
        if tuple(a.shape) != tuple(node.shape):
            raise ValueError(
                f"snapshot leaf shape {tuple(a.shape)} != template {tuple(node.shape)}; "
                "the snapshot was taken for a different world/config"
            )
        if prefix in _U32_LEAVES:
            a = a.astype(np.int64)
        return torch.from_numpy(np.array(a, order="C")).to(device=node.device, dtype=node.dtype)

    return build(like, "")
