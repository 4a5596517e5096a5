"""IP address assignment for simulated hosts.

Mirrors the reference's IpAssignment (reference:
src/main/network/graph/mod.rs:356-422): hosts may pin an explicit address;
everything else is auto-assigned sequentially from 11.0.0.0, skipping
addresses whose last octet is .0 or .255 (and any address already taken).
"""

from __future__ import annotations

import ipaddress


class IpAssignment:
    AUTO_BASE = int(ipaddress.IPv4Address("11.0.0.0"))

    def __init__(self):
        self._ip_to_host: dict[int, int] = {}
        self._host_to_ip: dict[int, int] = {}
        self._next_auto = self.AUTO_BASE

    def assign_explicit(self, host: int, ip: "str | int") -> int:
        addr = int(ipaddress.IPv4Address(ip)) if isinstance(ip, str) else int(ip)
        if addr in self._ip_to_host:
            raise ValueError(f"ip {ipaddress.IPv4Address(addr)} already assigned")
        if host in self._host_to_ip:
            raise ValueError(f"host {host} already has an address")
        self._ip_to_host[addr] = host
        self._host_to_ip[host] = addr
        return addr

    def assign_auto(self, host: int) -> int:
        if host in self._host_to_ip:
            raise ValueError(f"host {host} already has an address")
        addr = self._next_auto
        while addr & 0xFF in (0, 255) or addr in self._ip_to_host:
            addr += 1
        self._next_auto = addr + 1
        self._ip_to_host[addr] = host
        self._host_to_ip[host] = addr
        return addr

    def host_for_ip(self, ip: "str | int") -> "int | None":
        addr = int(ipaddress.IPv4Address(ip)) if isinstance(ip, str) else int(ip)
        return self._ip_to_host.get(addr)

    def ip_for_host(self, host: int) -> "int | None":
        return self._host_to_ip.get(host)

    def ip_str(self, host: int) -> str:
        return str(ipaddress.IPv4Address(self._host_to_ip[host]))

    def __len__(self) -> int:
        return len(self._ip_to_host)
