"""Gossip membership with churn: the overlay pack's fan-out-heavy model
(port of shadow_tpu/models/overlay/gossip.py).

Every host keeps a small partial view of the peer set and, on a periodic
tick, pushes a digest (its own id plus two sampled view entries) to
`fanout` peers drawn from the view, so one local event becomes F
cross-host packets. Each tick also draws a join/leave toggle
(probability churn_ppm / 1e6); an offline host skips its sends and
ignores incoming digests (counted). Receivers merge unseen ids into
deterministic view slots, with no draw on the receive path. Packet
plane only.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.engine.state import EngineConfig, LocalEmits, PacketEmits
from shadow_tpu_torch.equeue import PAYLOAD_LANES
from shadow_tpu_torch.events import KIND_MODEL_BASE, KIND_PACKET
from shadow_tpu_torch.simtime import NS_PER_MS

KIND_GOSSIP_TICK = KIND_MODEL_BASE  # periodic per-host gossip round

# digest payload lanes: two sampled view entries ride along the sender id
# (ev.src_host is the sender, from the tie key)
LANE_SAMPLE_A = 0
LANE_SAMPLE_B = 1


@dataclasses.dataclass
class GossipState:
    view: torch.Tensor  # [H, V] i32 known peer ids
    online: torch.Tensor  # [H] bool currently joined
    ticks: torch.Tensor  # [H] i64 gossip rounds taken (online only)
    msgs_recv: torch.Tensor  # [H] i64 digests accepted
    merges: torch.Tensor  # [H] i64 new ids merged into the view
    drops_offline: torch.Tensor  # [H] i64 digests ignored while offline
    churn_events: torch.Tensor  # [H] i64 join/leave toggles


@dataclasses.dataclass(frozen=True)
class GossipModel:
    num_hosts: int
    view_size: int = 8  # V: partial-view slots per host
    fanout: int = 3  # F: digests pushed per tick
    interval_ns: int = 50 * NS_PER_MS
    churn_ppm: int = 20_000  # per-tick join/leave probability, ppm (2%)
    msg_bytes: int = 256  # digest wire size
    start_ns: int = 1 * NS_PER_MS

    BOOTSTRAP_DRAWS = 1  # initial tick phase offset
    LOCAL_EMITS = 1  # the next tick

    @property
    def DRAWS_PER_EVENT(self):  # noqa: N802
        return 1 + self.fanout  # churn toggle + one target per digest

    @property
    def PACKET_EMITS(self):  # noqa: N802
        return self.fanout

    def __post_init__(self):
        if self.view_size < 2:
            raise ValueError("view_size must be >= 2 (digests sample two)")
        if self.fanout < 1:
            raise ValueError("fanout must be >= 1")
        if not 0 <= self.churn_ppm < 1_000_000:
            raise ValueError("churn_ppm must be in [0, 1e6)")
        if self.num_hosts < self.view_size + 1:
            raise ValueError("need num_hosts > view_size (views exclude self)")

    def init(self, device="cuda") -> GossipState:
        """The model's initial state on `device` (the card unless asked
        for the CPU): host h's view is h+1 .. h+V, all online."""
        dev = resolve_device(device)
        h, v = self.num_hosts, self.view_size
        host = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
        view = (host + 1 + torch.arange(v, dtype=torch.int32, device=dev)[None, :]) % h

        def z():
            return torch.zeros((h,), dtype=torch.int64, device=dev)

        return GossipState(
            view=view.to(torch.int32),
            online=torch.ones((h,), dtype=torch.bool, device=dev),
            ticks=z(), msgs_recv=z(), merges=z(), drops_offline=z(), churn_events=z(),
        )

    def _tick_at(self, valid, time) -> LocalEmits:
        h = valid.shape[0]
        dev = valid.device
        return LocalEmits(
            valid=valid[:, None],
            time=time[:, None],
            kind=torch.full((h, 1), KIND_GOSSIP_TICK, dtype=torch.int32, device=dev),
            data=torch.zeros((h, 1, PAYLOAD_LANES), dtype=torch.int32, device=dev),
        )

    def bootstrap(self, draw, host_id) -> LocalEmits:
        offset = draw.uniform_int(0, 0, max(self.interval_ns, 1))
        return self._tick_at(torch.ones_like(host_id, dtype=torch.bool),
                             self.start_ns + offset)

    @staticmethod
    def _view_at(view, idx):
        oh = torch.arange(view.shape[1], dtype=torch.int32, device=view.device)[None, :] == idx[:, None]
        return torch.where(oh, view, 0).sum(dim=1).to(torch.int32)

    def handle(self, state: GossipState, ev, draw, cfg: EngineConfig, host_id):
        h = host_id.shape[0]
        dev = host_id.device
        i32, i64 = torch.int32, torch.int64
        v = self.view_size
        f = self.fanout

        # --- tick: churn toggle, then push digests if online -------------
        m_tick = ev.valid & (ev.kind == KIND_GOSSIP_TICK)
        flip = m_tick & (draw.uniform_int(0, 0, 1_000_000) < self.churn_ppm)
        online = state.online ^ flip
        m_send = m_tick & online

        # two deterministic view samples ride every digest (rotating with
        # the tick counter so views mix without extra draws)
        base = (state.ticks % v).to(i32)
        digest = torch.zeros((h, PAYLOAD_LANES), dtype=i32, device=dev)
        digest[:, LANE_SAMPLE_A] = self._view_at(state.view, base)
        digest[:, LANE_SAMPLE_B] = self._view_at(state.view, (base + 1) % v)
        targets = [
            self._view_at(state.view, draw.uniform_int(1 + j, 0, v).to(i32))
            for j in range(f)
        ]
        pemits = PacketEmits(
            valid=m_send[:, None].expand(h, f).clone(),
            dst=torch.stack(targets, dim=1),
            data=digest[:, None, :].expand(h, f, PAYLOAD_LANES).clone(),
            size=torch.full((h, f), self.msg_bytes, dtype=i32, device=dev),
        )

        # ticks reschedule even while offline — churn can rejoin a host
        lemits = self._tick_at(m_tick, ev.time + self.interval_ns)

        # --- digest arrival: merge sender + samples into the view --------
        is_digest = ev.valid & (ev.kind == KIND_PACKET)
        m_recv = is_digest & online
        m_drop = is_digest & ~online
        view = state.view
        merged = torch.zeros((h,), dtype=i64, device=dev)
        recv_ctr = state.msgs_recv + m_recv.to(i64)
        cands = (
            ev.src_host.to(i32),
            ev.data[:, LANE_SAMPLE_A],
            ev.data[:, LANE_SAMPLE_B],
        )
        slots = torch.arange(v, dtype=i32, device=dev)[None, :]
        for k, cand in enumerate(cands):
            present = (view == cand[:, None]).any(dim=1) | (cand == host_id) | (cand < 0)
            ins = m_recv & ~present
            slot = ((recv_ctr * 3 + k) % v).to(i32)
            slot_oh = (slots == slot[:, None]) & ins[:, None]
            view = torch.where(slot_oh, cand[:, None], view)
            merged = merged + ins.to(i64)

        state = GossipState(
            view=view,
            online=online,
            ticks=state.ticks + m_send.to(i64),
            msgs_recv=recv_ctr,
            merges=state.merges + merged,
            drops_offline=state.drops_offline + m_drop.to(i64),
            churn_events=state.churn_events + flip.to(i64),
        )
        return state, lemits, pemits
