"""DNS: the simulation-wide name <-> IP <-> host-id registry.

Rebuild of the reference's DNS subsystem (network/dns.rs:86-190): a static
registry built before the simulation starts (every host registers its
hostname and IP), answering forward lookups (hostname -> host), reverse
lookups (IP -> host), and emitting an ``/etc/hosts``-style file that managed
plugins resolve against — the reference passes that file to plugins as a
memfd so unmodified libc resolvers see the simulated names; here the path
travels in the plugin environment (``SHADOW_TPU_HOSTS_FILE``) and the shim's
``getaddrinfo`` reads it locally, no channel hop.

Lookup accepts three spellings (single-sourced for both backends so model
configs behave identically on cpu and tpu): a registered hostname, a dotted
IPv4 string, or a bare numeric host id (model-config convenience).

The JAX package's ``net/dns.py``, copied into the port unchanged in law
(plain Python and numpy, no JAX).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional


class DnsError(ValueError):
    pass


class Dns:
    """Static pre-sim registry; immutable once the engines start."""

    def __init__(self) -> None:
        self._by_name: dict[str, int] = {}
        self._by_ip: dict[str, int] = {}
        self._name_of: dict[int, str] = {}
        self._ip_of: dict[int, str] = {}

    def register(self, host_id: int, hostname: str, ip: str) -> None:
        if hostname in self._by_name:
            raise DnsError(f"duplicate hostname {hostname!r}")
        if ip in self._by_ip:
            raise DnsError(f"duplicate IP {ip}")
        if host_id in self._name_of:
            raise DnsError(f"host id {host_id} registered twice")
        self._by_name[hostname] = host_id
        self._by_ip[ip] = host_id
        self._name_of[host_id] = hostname
        self._ip_of[host_id] = ip

    # -- lookups -----------------------------------------------------------

    def __len__(self) -> int:
        return len(self._name_of)

    def resolve(self, name: str) -> int:
        """hostname | IPv4 string | numeric host id -> host id."""
        hid = self.try_resolve(name)
        if hid is None:
            raise DnsError(f"unknown hostname {name!r}")
        return hid

    def try_resolve(self, name: str) -> Optional[int]:
        hid = self._by_name.get(name)
        if hid is not None:
            return hid
        hid = self._by_ip.get(name)
        if hid is not None:
            return hid
        try:
            hid = int(name)
        except ValueError:
            return None
        return hid if 0 <= hid < len(self._name_of) else None

    def ip_of(self, host_id: int) -> str:
        return self._ip_of[host_id]

    def name_of(self, host_id: int) -> str:
        return self._name_of[host_id]

    def host_for_ip(self, ip: str) -> Optional[int]:
        return self._by_ip.get(ip)

    # -- hosts-file emission (dns.rs:130-190) ------------------------------

    def hosts_file(self) -> str:
        """``/etc/hosts``-style text: loopback first, then every simulated
        host in id order (deterministic byte-for-byte)."""
        lines = ["127.0.0.1 localhost\n"]
        for hid in sorted(self._name_of):
            lines.append(f"{self._ip_of[hid]} {self._name_of[hid]}\n")
        return "".join(lines)

    def write_hosts_file(self, path: str | Path) -> Path:
        """Atomic (tmp + rename): MpCpuEngine worker replicas all write
        this file concurrently while other workers' managed processes may
        be resolving through it — a truncate-then-write would expose an
        empty file mid-write.  Every replica writes identical bytes, so
        the last rename is a no-op content-wise."""
        import os

        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
        tmp.write_text(self.hosts_file())
        os.replace(tmp, path)
        return path
