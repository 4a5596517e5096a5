"""Global name <-> IP registry for the simulation
(port of shadow_tpu/hostk/dns.py).

Rebuilds the reference DNS (reference: src/main/routing/dns.c:115
dns_register / :180 dns_resolveIPToAddress, plus the /etc/hosts-style
file it writes for managed processes; the shim-side getaddrinfo
emulation is src/lib/shim/shim_api_addrinfo.c). Python dicts replace the
GMutex'd GHashTables — the kernel is single-threaded per event.
"""

from __future__ import annotations

import ipaddress
import pathlib


class Dns:
    def __init__(self):
        self.name_to_ip: dict[str, int] = {}
        self.ip_to_name: dict[int, str] = {}

    def register(self, name: str, ip: int) -> None:
        if name in self.name_to_ip:
            raise ValueError(f"duplicate hostname {name!r}")
        if ip in self.ip_to_name:
            raise ValueError(f"duplicate ip {ip} ({self.ip_to_name[ip]!r}, {name!r})")
        self.name_to_ip[name] = ip
        self.ip_to_name[ip] = name

    def resolve(self, name: str) -> int | None:
        """name -> ip; numeric dotted-quads resolve without registration."""
        if name in self.name_to_ip:
            return self.name_to_ip[name]
        if name in ("localhost", "localhost.localdomain"):
            return int(ipaddress.IPv4Address("127.0.0.1"))
        try:
            return int(ipaddress.IPv4Address(name))
        except ValueError:
            return None

    def reverse(self, ip: int) -> str | None:
        return self.ip_to_name.get(ip)

    def write_hosts_file(self, path: str | pathlib.Path) -> None:
        """The managed-process-visible hosts file (dns.c writes the same)."""
        with open(path, "w") as f:
            f.write("127.0.0.1 localhost\n")
            for name, ip in sorted(self.name_to_ip.items(), key=lambda kv: kv[1]):
                f.write(f"{ipaddress.IPv4Address(ip)} {name}\n")
