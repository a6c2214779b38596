"""DNS: the simulation-wide name <-> IP <-> host-id registry.

Rebuild of the reference's DNS subsystem (network/dns.rs:86-190): a static
registry built before the simulation starts (every host registers its
hostname and IP), answering forward lookups.

Lookup accepts three spellings, as the JAX package's does: a registered
hostname, a dotted IPv4 string, or a bare numeric host id.
"""

from __future__ import annotations

from typing import Optional


class DnsError(ValueError):
    pass


class Dns:
    """Static pre-sim registry; immutable once the engine starts."""

    def __init__(self) -> None:
        self._by_name: dict[str, int] = {}
        self._by_ip: dict[str, int] = {}
        self._name_of: dict[int, str] = {}

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
