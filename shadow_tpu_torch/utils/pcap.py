"""Per-host pcap capture of simulated traffic (port of
shadow_tpu/utils/pcap.py).

Rebuilds the reference's packet capture (reference:
src/main/utility/pcap_writer.rs:6,57 — classic pcap format, one file per
NIC; enabled per host via host options, network_interface.c:425-436).
Writes standard little-endian pcap v2.4 with LINKTYPE_RAW (101): each
record is a synthesized IPv4 packet with a UDP or TCP header, so the
files open in wireshark/tcpdump.
"""

from __future__ import annotations

import pathlib
import struct

PCAP_MAGIC = 0xA1B23C4D  # nanosecond-resolution pcap
LINKTYPE_RAW = 101

_TCP_FLAG_MAP = (
    (1, 0x02),  # our SYN -> TCP SYN
    (2, 0x10),  # ACK
    (4, 0x01),  # FIN
    (8, 0x04),  # RST
)


def _ipv4(src_ip: int, dst_ip: int, proto: int, payload: bytes) -> bytes:
    if len(payload) > 65515:  # keep the u16 total-length field valid
        payload = payload[:65515]
    total = 20 + len(payload)
    hdr = struct.pack(
        ">BBHHHBBHII",
        0x45, 0, total, 0, 0, 64, proto, 0, src_ip & 0xFFFFFFFF, dst_ip & 0xFFFFFFFF,
    )
    return hdr + payload


def _udp_hdr(sport: int, dport: int, data: bytes) -> bytes:
    return struct.pack(">HHHH", sport & 0xFFFF, dport & 0xFFFF, 8 + len(data), 0) + data


def _tcp_hdr(sport: int, dport: int, seq: int, ack: int, flags: int, wnd: int, data: bytes) -> bytes:
    tf = 0
    for ours, theirs in _TCP_FLAG_MAP:
        if flags & ours:
            tf |= theirs
    return (
        struct.pack(
            ">HHIIBBHHH",
            sport & 0xFFFF,
            dport & 0xFFFF,
            seq & 0xFFFFFFFF,
            ack & 0xFFFFFFFF,
            5 << 4,
            tf,
            min(wnd, 0xFFFF),
            0,
            0,
        )
        + data
    )


class PcapWriter:
    def __init__(self, path: str | pathlib.Path):
        self._f = open(path, "wb")
        self._f.write(
            struct.pack("<IHHiIII", PCAP_MAGIC, 2, 4, 0, 0, 65535, LINKTYPE_RAW)
        )

    def record(self, t_ns: int, packet: bytes) -> None:
        sec, nsec = divmod(t_ns, 1_000_000_000)
        self._f.write(struct.pack("<IIII", sec, nsec, len(packet), len(packet)))
        self._f.write(packet)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class PcapDir:
    """One pcap file per host, under <data-dir>/<host>/eth0.pcap (the
    reference writes <hostname>-<iface>.pcap per NIC)."""

    def __init__(self, data_dir: str | pathlib.Path, host_names: "list[str]"):
        self._writers: dict[str, PcapWriter] = {}
        base = pathlib.Path(data_dir)
        for name in host_names:
            d = base / name
            d.mkdir(parents=True, exist_ok=True)
            self._writers[name] = PcapWriter(d / "eth0.pcap")

    def udp(self, host: str, t_ns: int, sip: int, sport: int, dip: int, dport: int, data: bytes) -> None:
        w = self._writers.get(host)
        if w:
            w.record(t_ns, _ipv4(sip, dip, 17, _udp_hdr(sport, dport, data)))

    def tcp(self, host: str, t_ns: int, seg) -> None:
        w = self._writers.get(host)
        if w:
            w.record(
                t_ns,
                _ipv4(
                    seg.src_ip,
                    seg.dst_ip,
                    6,
                    _tcp_hdr(
                        seg.src_port, seg.dst_port, seg.seq, seg.ack, seg.flags, seg.wnd, seg.payload
                    ),
                ),
            )

    def close(self) -> None:
        for w in self._writers.values():
            w.close()
