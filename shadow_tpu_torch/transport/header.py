"""Packet header lanes (port of shadow_tpu/transport/header.py).

lane 0: (src_port << 16) | dst_port        (u16 each)
lane 1: seq  (wire u32; i64 stream offsets are unwrapped via unwrap32)
lane 2: ack  (wire u32)
lane 3: flags | (payload_len << 8)         (flags: FIN/SYN/RST/ACK)
lane 4: advertised receive window, bytes
lane 5: free for app/model use; the TCP machine never writes it
lane 6: SACK block start (wire u32; 0 == lane 7 means no block)
lane 7: SACK block end   (wire u32, exclusive)
"""

from __future__ import annotations

import torch

LANE_PORTS = 0
LANE_SEQ = 1
LANE_ACK = 2
LANE_FLAGS_LEN = 3
LANE_WND = 4
LANE_APP = 5
LANE_SACK_S = 6
LANE_SACK_E = 7

FLAG_FIN = 0x01
FLAG_SYN = 0x02
FLAG_RST = 0x04
FLAG_ACK = 0x10


def pack_ports(src_port, dst_port):
    return (src_port.to(torch.int32) << 16) | (dst_port.to(torch.int32) & 0xFFFF)


def unpack_ports(lane0):
    return (lane0 >> 16) & 0xFFFF, lane0 & 0xFFFF


def pack_flags_len(flags, payload_len):
    return (flags.to(torch.int32) & 0xFF) | (payload_len.to(torch.int32) << 8)


def unpack_flags_len(lane3):
    return lane3 & 0xFF, (lane3 >> 8) & 0xFFFFFF


def to_wire32(seq_i64):
    """Low 32 bits of an absolute i64 stream offset, as the i32 wire lane."""
    return (seq_i64 & 0xFFFFFFFF).to(torch.int32)


def unwrap32(near_i64, wire_i32):
    """The absolute i64 offset closest to `near` whose low 32 bits equal
    `wire` (serial-number unwrap)."""
    wire_u = wire_i32.to(torch.int64) & 0xFFFFFFFF
    delta = ((wire_u - (near_i64 & 0xFFFFFFFF) + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)
    return near_i64 + delta
