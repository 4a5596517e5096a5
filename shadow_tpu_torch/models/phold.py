"""PHOLD: the classic PDES benchmark workload (port of
shadow_tpu/models/phold.py).

On receiving a ball (packet), a host draws a random hold delay and a
random peer, holds, then throws the ball on.

Event kinds:
  KIND_PACKET — a ball arrives        (draws: dst, hold-delay -> local SEND)
  KIND_SEND   — hold expired          (emits the packet)

All timing draws are integer-valued, so timelines are bit-identical
across devices.
"""

from __future__ import annotations

import dataclasses

import torch

from shadow_tpu_torch.device import resolve_device
from shadow_tpu_torch.engine.state import EngineConfig, LocalEmits, PacketEmits
from shadow_tpu_torch.equeue import PAYLOAD_LANES
from shadow_tpu_torch.events import KIND_MODEL_BASE, KIND_PACKET
from shadow_tpu_torch.simtime import NS_PER_MS

KIND_SEND = KIND_MODEL_BASE  # 1


@dataclasses.dataclass
class PholdState:
    recv_count: torch.Tensor  # [H] i64 balls received
    send_count: torch.Tensor  # [H] i64 balls thrown


@dataclasses.dataclass(frozen=True)
class PholdModel:
    num_hosts: int
    min_delay_ns: int = 1 * NS_PER_MS
    max_delay_ns: int = 20 * NS_PER_MS  # exclusive
    ball_bytes: int = 0  # wire size per ball; feeds the relays when shaped

    DRAWS_PER_EVENT = 2  # (dst, delay) on ball arrival
    LOCAL_EMITS = 1
    PACKET_EMITS = 1
    BOOTSTRAP_DRAWS = 2  # (dst, initial offset)

    def init(self, device="cuda") -> PholdState:
        """The model's initial state on `device` (the card unless asked
        for the CPU)."""
        dev = resolve_device(device)
        z = torch.zeros((self.num_hosts,), dtype=torch.int64, device=dev)
        return PholdState(recv_count=z, send_count=z.clone())

    def _draw_peer(self, draw, i: int, host_id) -> torch.Tensor:
        """Uniform peer excluding self (any host if there is only one)."""
        h = self.num_hosts
        if h == 1:
            return torch.zeros(host_id.shape, dtype=torch.int32, device=host_id.device)
        peer = draw.uniform_int(i, 0, h - 1)
        return (peer + (peer >= host_id.to(torch.int64)).to(torch.int64)).to(torch.int32)

    def _send_at(self, dst, time) -> LocalEmits:
        h = dst.shape[0]
        data = torch.zeros((h, 1, PAYLOAD_LANES), dtype=torch.int32, device=dst.device)
        data[:, 0, 0] = dst
        return LocalEmits(
            valid=torch.ones((h, 1), dtype=torch.bool, device=dst.device),
            time=time[:, None],
            kind=torch.full((h, 1), KIND_SEND, dtype=torch.int32, device=dst.device),
            data=data,
        )

    def bootstrap(self, draw, host_id) -> LocalEmits:
        """Every host starts holding one ball: SEND at a random offset."""
        dst = self._draw_peer(draw, 0, host_id)
        offset = draw.uniform_int(1, self.min_delay_ns, self.max_delay_ns)
        return self._send_at(dst, offset)

    def handle(self, state: PholdState, ev, draw, cfg: EngineConfig, host_id):
        h = host_id.shape[0]
        dev = host_id.device
        is_ball = ev.valid & (ev.kind == KIND_PACKET)
        is_send = ev.valid & (ev.kind == KIND_SEND)

        # ball arrival: hold it, schedule the throw
        dst = self._draw_peer(draw, 0, host_id)
        delay = draw.uniform_int(1, self.min_delay_ns, self.max_delay_ns)
        lemits = self._send_at(dst, ev.time + delay)
        lemits.valid = is_ball[:, None]

        # hold expired: throw the ball to the peer recorded in the timer
        pemits = PacketEmits(
            valid=is_send[:, None],
            dst=ev.data[:, 0][:, None],
            data=torch.zeros((h, 1, PAYLOAD_LANES), dtype=torch.int32, device=dev),
            size=torch.full((h, 1), self.ball_bytes, dtype=torch.int32, device=dev),
        )
        state = PholdState(
            recv_count=state.recv_count + is_ball.to(torch.int64),
            send_count=state.send_count + is_send.to(torch.int64),
        )
        return state, lemits, pemits
