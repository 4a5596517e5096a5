"""Device-side network plane for managed (real-executable) traffic (port
of shadow_tpu/models/managed_net.py).

This is the hybrid-coupling model: managed processes execute on the CPU
host kernel (hostk/), but every non-loopback packet they emit rides the
device engine — egress token bucket, loss draw, routing latency, ingress
token bucket + CoDel — exactly like scripted traffic (reference: the one
round loop serving real processes, src/main/core/manager.rs:392-478;
clamp semantics worker.rs:399-402).

The model itself holds no behavior: its events are
  KIND_MSEND  — a send staged by the CPU kernel (payload lanes carry the
                destination host, the CPU-side payload id, the wire size,
                and the loss-draw counter the CPU allocated at send time);
                handling emits the packet into the engine's packet path.
  KIND_PACKET — an arrival that passed ingress shaping; it is *recorded*
                into a per-host buffer the CPU kernel drains at the next
                round boundary and delivers into sockets.

Loss/drop outcomes are recorded the same way (through the engine's
on_packet_outcomes / on_codel_drop hooks) so the CPU can log drops, free
payloads, and keep per-host stats identical to the pure-CPU kernel.

Determinism: the loss uniform is threefry(src_host_key, counter) where the
counter was allocated from the host's stream *at send time on the CPU* —
bit-identical to the serial kernel's _loss_draw, regardless of device
pop order (LOSS_COUNTER_LANE tells the engine to use the carried counter
instead of the host's live stream).
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.engine.state import EngineConfig, LocalEmits, PacketEmits
from shadow_tpu_torch.equeue import PAYLOAD_LANES
from shadow_tpu_torch.events import KIND_MODEL_BASE, KIND_PACKET

KIND_MSEND = KIND_MODEL_BASE  # 1

# payload lane layout for managed sends (and their arrival records);
# (src, seq) keys the CPU-side payload table
LANE_DST = 0  # destination host id
LANE_SRC = 1  # source host id
LANE_SIZE = 2  # wire size in bytes
LANE_CTR = 3  # loss-draw counter allocated at send time
LANE_SEQ = 4  # source host's send sequence number

# record flags
REC_DELIVER = 1  # recorded at dst: arrival passed ingress at rec time
REC_LOSS_DROP = 2  # recorded at src: lost to path packet_loss at send time
REC_CODEL_DROP = 3  # recorded at dst: dropped by the ingress AQM


@dataclasses.dataclass
class ManagedNetState:
    """Per-host record ring the CPU drains after every device round."""

    rec_time: torch.Tensor  # [H, A] i64
    rec_data: torch.Tensor  # [H, A, PAYLOAD_LANES] i32
    rec_flag: torch.Tensor  # [H, A] i32 (REC_*; 0 = empty)
    rec_count: torch.Tensor  # [H] i32
    rec_overflow: torch.Tensor  # [H] i32


def _no_local_emits(h: int, device) -> LocalEmits:
    return LocalEmits(
        valid=torch.zeros((h, 1), dtype=torch.bool, device=device),
        time=torch.zeros((h, 1), dtype=torch.int64, device=device),
        kind=torch.zeros((h, 1), dtype=torch.int32, device=device),
        data=torch.zeros((h, 1, PAYLOAD_LANES), dtype=torch.int32, device=device),
    )


@dataclasses.dataclass(frozen=True)
class ManagedNetModel:
    num_hosts: int
    record_capacity: int = 128

    DRAWS_PER_EVENT = 0
    LOCAL_EMITS = 0
    PACKET_EMITS = 1
    BOOTSTRAP_DRAWS = 0
    # engine hook: loss uniforms come from the carried counter lane, and the
    # host's live rng stream is neither read nor advanced by packet sends
    LOSS_COUNTER_LANE = LANE_CTR

    def init(self, device="cuda") -> ManagedNetState:
        """The empty record ring on `device` (the card unless asked for
        the CPU)."""
        dev = resolve_device(device)
        h, a = self.num_hosts, self.record_capacity
        return ManagedNetState(
            rec_time=torch.zeros((h, a), dtype=torch.int64, device=dev),
            rec_data=torch.zeros((h, a, PAYLOAD_LANES), dtype=torch.int32, device=dev),
            rec_flag=torch.zeros((h, a), dtype=torch.int32, device=dev),
            rec_count=torch.zeros((h,), dtype=torch.int32, device=dev),
            rec_overflow=torch.zeros((h,), dtype=torch.int32, device=dev),
        )

    def bootstrap(self, draw, host_id) -> LocalEmits:
        return _no_local_emits(host_id.shape[0], host_id.device)

    @staticmethod
    def _record(state: ManagedNetState, valid, time, data, flag: int) -> ManagedNetState:
        """Append one record per host where valid (row-local, conflict-free)."""
        a = state.rec_flag.shape[1]
        lane = torch.arange(a, device=valid.device)[None, :]
        has_room = state.rec_count < a
        write = valid & has_room
        at = (lane == state.rec_count[:, None].to(torch.int64)) & write[:, None]
        return ManagedNetState(
            rec_time=torch.where(at, time[:, None], state.rec_time),
            rec_data=torch.where(at[:, :, None], data[:, None, :], state.rec_data),
            rec_flag=torch.where(at, torch.full_like(state.rec_flag, flag), state.rec_flag),
            rec_count=state.rec_count + write.to(torch.int32),
            rec_overflow=state.rec_overflow + (valid & ~has_room).to(torch.int32),
        )

    def handle(self, state: ManagedNetState, ev, draw, cfg: EngineConfig, host_id):
        h = host_id.shape[0]
        is_arrival = ev.valid & (ev.kind == KIND_PACKET)
        is_send = ev.valid & (ev.kind == KIND_MSEND)

        # arrival passed ingress: record for CPU delivery
        state = self._record(state, is_arrival, ev.time, ev.data, REC_DELIVER)

        # send: hand the payload lanes to the engine's packet path verbatim
        pemits = PacketEmits(
            valid=is_send[:, None],
            dst=ev.data[:, LANE_DST][:, None],
            data=ev.data[:, None, :],
            size=ev.data[:, LANE_SIZE][:, None],
        )
        return state, _no_local_emits(h, host_id.device), pemits

    def on_packet_outcomes(
        self, state: ManagedNetState, ev, pemits, kept, dropped, unroutable, deliver, dst
    ) -> ManagedNetState:
        """Record path-loss drops at the source (the CPU logs them and
        frees the payload). Unroutable sends never reach the device (the
        CPU kernel checks the routing table at send time)."""
        return self._record(state, dropped[:, 0], ev.time, pemits.data[:, 0, :], REC_LOSS_DROP)

    def on_codel_drop(self, state: ManagedNetState, ev, drop_mask) -> ManagedNetState:
        """Record ingress-AQM drops at the destination."""
        return self._record(state, drop_mask, ev.time, ev.data, REC_CODEL_DROP)

    def reset_records(self, state: ManagedNetState) -> ManagedNetState:
        return dataclasses.replace(
            state,
            rec_count=torch.zeros_like(state.rec_count),
            rec_flag=torch.zeros_like(state.rec_flag),
        )
