"""CDN cache hierarchy: the overlay pack's fan-in-heavy model (port of
shadow_tpu/models/overlay/cdn.py).

World layout (roles by host index):

  host 0                      origin — authoritative for every object
  hosts [1, 1+NM)             mid caches
  hosts [1+NM, 1+NM+NL)       leaf caches
  hosts [1+NM+NL, H)          clients — each pinned to one leaf

Caches are direct-mapped object-id tables (slot = obj % slots): a hit
serves at once, a miss forwards the request up with the requester and
the cache chain riding the payload lanes; the response retraces the
chain, filling each cache on the way down. Packet plane only (no TCP);
requests draw the object id from the seeded per-host stream.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.engine.state import EngineConfig, LocalEmits, PacketEmits
from shadow_tpu_torch.equeue import PAYLOAD_LANES
from shadow_tpu_torch.events import KIND_MODEL_BASE, KIND_PACKET
from shadow_tpu_torch.simtime import NS_PER_MS

KIND_FETCH = KIND_MODEL_BASE  # client: draw an object, ask the leaf

# payload lanes of REQ/RESP packets
LANE_OBJ = 0
LANE_REQUESTER = 1
LANE_LEAF = 2
LANE_MID = 3
LANE_TAG = 4
TAG_REQ = 1
TAG_RESP = 2


@dataclasses.dataclass
class CdnState:
    cache: torch.Tensor  # [H, SLOTS] i32 object id per direct-mapped slot (-1)
    reqs: torch.Tensor  # [H] i64 client requests issued
    hits: torch.Tensor  # [H] i64 cache hits served (leaf+mid)
    misses: torch.Tensor  # [H] i64 cache misses forwarded up
    fills: torch.Tensor  # [H] i64 cache inserts on the response path
    resp_recv: torch.Tensor  # [H] i64 client responses received
    bytes_down: torch.Tensor  # [H] i64 client object bytes received


@dataclasses.dataclass(frozen=True)
class CdnModel:
    num_hosts: int
    num_mids: int = 2
    num_leaves: int = 4
    objects: int = 256  # catalog size the clients draw from
    leaf_slots: int = 8  # direct-mapped slots per leaf cache
    mid_slots: int = 32  # direct-mapped slots per mid cache
    obj_bytes: int = 20_000  # response wire size
    req_bytes: int = 100  # request wire size
    pause_ns: int = 100 * NS_PER_MS
    start_ns: int = 1 * NS_PER_MS

    DRAWS_PER_EVENT = 1  # object id on KIND_FETCH
    LOCAL_EMITS = 1  # next-fetch timer
    PACKET_EMITS = 1  # one REQ or RESP hop per event
    BOOTSTRAP_DRAWS = 1  # initial fetch phase offset

    def __post_init__(self):
        if self.num_mids < 1 or self.num_leaves < 1:
            raise ValueError("need at least one mid and one leaf cache")
        if 1 + self.num_mids + self.num_leaves >= self.num_hosts:
            raise ValueError("need num_hosts > 1 + mids + leaves (the rest are clients)")
        if self.objects < 1:
            raise ValueError("objects must be >= 1")
        if self.leaf_slots < 1 or self.mid_slots < 1:
            raise ValueError("cache slots must be >= 1")

    @property
    def slots(self) -> int:
        return max(self.leaf_slots, self.mid_slots)

    @property
    def _mid0(self) -> int:
        return 1

    @property
    def _leaf0(self) -> int:
        return 1 + self.num_mids

    @property
    def _client0(self) -> int:
        return 1 + self.num_mids + self.num_leaves

    def _roles(self, host_id):
        is_origin = host_id == 0
        is_mid = (host_id >= self._mid0) & (host_id < self._leaf0)
        is_leaf = (host_id >= self._leaf0) & (host_id < self._client0)
        is_client = host_id >= self._client0
        return is_origin, is_mid, is_leaf, is_client

    def init(self, device="cuda") -> CdnState:
        """The model's initial state on `device` (the card unless asked
        for the CPU): every cache empty."""
        dev = resolve_device(device)
        h = self.num_hosts

        def z():
            return torch.zeros((h,), dtype=torch.int64, device=dev)

        return CdnState(
            cache=torch.full((h, self.slots), -1, dtype=torch.int32, device=dev),
            reqs=z(), hits=z(), misses=z(), fills=z(), resp_recv=z(), bytes_down=z(),
        )

    def _fetch_at(self, valid, time) -> LocalEmits:
        h = valid.shape[0]
        dev = valid.device
        return LocalEmits(
            valid=valid[:, None],
            time=time[:, None],
            kind=torch.full((h, 1), KIND_FETCH, dtype=torch.int32, device=dev),
            data=torch.zeros((h, 1, PAYLOAD_LANES), dtype=torch.int32, device=dev),
        )

    def bootstrap(self, draw, host_id) -> LocalEmits:
        _, _, _, is_client = self._roles(host_id)
        offset = draw.uniform_int(0, 0, max(self.pause_ns, 1))
        return self._fetch_at(is_client, self.start_ns + offset)

    def _cache_probe(self, state, obj, is_mid):
        eff = torch.where(is_mid, self.mid_slots, self.leaf_slots)
        slot = (obj % eff).to(torch.int32)
        slot_oh = torch.arange(self.slots, dtype=torch.int32, device=obj.device)[None, :] == slot[:, None]
        hit = (slot_oh & (state.cache == obj[:, None])).any(dim=1)
        return slot_oh, hit

    def handle(self, state: CdnState, ev, draw, cfg: EngineConfig, host_id):
        h = host_id.shape[0]
        dev = host_id.device
        W = torch.where
        i32, i64 = torch.int32, torch.int64
        is_origin, is_mid, is_leaf, is_client = self._roles(host_id)
        is_pkt = ev.valid & (ev.kind == KIND_PACKET)
        tag = ev.data[:, LANE_TAG]
        m_req = is_pkt & (tag == TAG_REQ)
        m_resp = is_pkt & (tag == TAG_RESP)
        obj = W(is_pkt, ev.data[:, LANE_OBJ], 0)

        # --- client: draw the next object, ask the pinned leaf -----------
        m_fetch = ev.valid & (ev.kind == KIND_FETCH) & is_client
        new_obj = draw.uniform_int(0, 0, self.objects).to(i32)
        my_leaf = (self._leaf0 + (host_id - self._client0) % self.num_leaves).to(i32)
        my_mid = (self._mid0 + (host_id - self._leaf0) % self.num_mids).to(i32)

        # --- cache probe at leaves/mids (REQ path) -----------------------
        is_cache = is_leaf | is_mid
        slot_oh, hit = self._cache_probe(state, obj, is_mid)
        m_hit = m_req & is_cache & hit
        m_miss = m_req & is_cache & ~hit

        # --- response path: fill the cache, pass it down -----------------
        m_fill = m_resp & is_cache
        changed = m_fill & ~hit
        cache = W(slot_oh & changed[:, None], obj[:, None], state.cache)
        m_client_resp = m_resp & is_client

        # --- the single packet lane this event emits ---------------------
        m_origin = m_req & is_origin
        requester = ev.data[:, LANE_REQUESTER]
        leaf_hop = ev.data[:, LANE_LEAF]
        mid_hop = ev.data[:, LANE_MID]

        out_req = m_fetch | m_miss
        out_resp = m_hit | m_origin | m_fill
        out_valid = out_req | out_resp
        # REQ: client -> its leaf; leaf miss -> its mid; mid miss -> origin
        req_dst = W(m_fetch, my_leaf, W(is_leaf, my_mid, 0))
        # RESP walks the recorded chain back down
        resp_dst = W(
            m_origin,
            W(mid_hop >= 0, mid_hop, leaf_hop),
            W(is_mid, leaf_hop, requester),
        )
        dst = W(out_req, req_dst, resp_dst).to(i32)

        data = torch.zeros((h, PAYLOAD_LANES), dtype=i32, device=dev)
        data[:, LANE_OBJ] = W(m_fetch, new_obj, obj)
        data[:, LANE_REQUESTER] = W(m_fetch, host_id, requester)
        data[:, LANE_LEAF] = W(m_fetch, -1, W(m_miss & is_leaf, host_id, leaf_hop))
        data[:, LANE_MID] = W(m_fetch, -1, W(m_miss & is_mid, host_id, mid_hop))
        data[:, LANE_TAG] = W(out_resp, TAG_RESP, TAG_REQ).to(i32)
        size = W(out_resp, self.obj_bytes, self.req_bytes).to(i32)
        pemits = PacketEmits(
            valid=out_valid[:, None], dst=dst[:, None], data=data[:, None, :],
            size=size[:, None],
        )

        # --- next fetch after the pause ----------------------------------
        lemits = self._fetch_at(m_client_resp, ev.time + self.pause_ns)

        state = CdnState(
            cache=cache,
            reqs=state.reqs + m_fetch.to(i64),
            hits=state.hits + m_hit.to(i64),
            misses=state.misses + m_miss.to(i64),
            fills=state.fills + changed.to(i64),
            resp_recv=state.resp_recv + m_client_resp.to(i64),
            bytes_down=state.bytes_down + W(m_client_resp, self.obj_bytes, 0).to(i64),
        )
        return state, lemits, pemits
