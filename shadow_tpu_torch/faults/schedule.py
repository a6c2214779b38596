"""Declarative fault schedules: parsing + validation (the JAX package's
``faults/schedule.py``, without the run-control console grammar).

The ``faults.events`` config list is parsed into typed
:class:`FaultEvent` records at config-validation time, so a typo'd kind
or an out-of-range loss fails the config — never the run.  Event kinds:

========================  =====================================================
``link_down``             remove the GML edge ``source``/``target`` from
                          routing (traffic reroutes if an alternative path
                          exists; otherwise the pair drops every packet)
``link_up``               restore the edge to its base properties (clears any
                          loss/latency override too)
``loss``                  set the edge's ``packet_loss`` to ``loss``
``latency``               set the edge's ``latency`` to ``latency``
``partition``             bipartition (or k-partition) the graph:
                          ``groups: [[0], [1, 2]]`` lists graph node ids;
                          pairs in *different* groups drop every packet;
                          nodes not listed are unaffected.  A new partition
                          replaces the previous one.
``heal``                  clear the active partition
``host_crash``            isolate ``host`` from the network entirely (every
                          packet to or from it drops); the host's own graph
                          node must not be shared with other hosts
``host_restart``          undo a ``host_crash``
``backend_stall``         inject a simulated backend failure: the lane
                          engine raises ``BackendStallError`` at this epoch
========================  =====================================================

Every event has an ``at:`` simulated time (unit string or bare seconds).
All times become deterministic *window-clamp epochs*: no round window
ever straddles a fault, which is what keeps a faulted run's event log
identical to the CPU oracle's and the JAX engine's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

from ..config import units


class FaultConfigError(ValueError):
    pass


LINK_KINDS = ("link_down", "link_up", "loss", "latency")
HOST_KINDS = ("host_crash", "host_restart")
KINDS = LINK_KINDS + HOST_KINDS + ("partition", "heal", "backend_stall")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One schedule entry.  Unused fields keep their neutral defaults so
    the record stays a plain, hashable value object."""

    at: int  # ns, > 0
    kind: str
    source: int = -1  # graph node id (link kinds)
    target: int = -1
    loss: float = -1.0  # [0,1] (kind == "loss")
    latency_ns: int = 0  # > 0 (kind == "latency")
    groups: tuple[tuple[int, ...], ...] = ()  # kind == "partition"
    host: str = ""  # hostname (host kinds)


def _parse_groups(v: Any) -> tuple[tuple[int, ...], ...]:
    if not isinstance(v, (list, tuple)) or len(v) < 2:
        raise FaultConfigError(
            "partition 'groups' must list at least two groups of graph "
            f"node ids, e.g. [[0], [1, 2]]; got {v!r}"
        )
    groups = []
    seen: set[int] = set()
    for g in v:
        if not isinstance(g, (list, tuple)) or not g:
            raise FaultConfigError(f"partition group must be a non-empty list, got {g!r}")
        ids = tuple(int(x) for x in g)
        dup = seen.intersection(ids)
        if dup or len(set(ids)) != len(ids):
            raise FaultConfigError(
                f"partition groups must be disjoint (node {sorted(dup or set(ids))[0]} repeats)"
            )
        seen.update(ids)
        groups.append(ids)
    return tuple(groups)


def parse_event(doc: dict[str, Any]) -> FaultEvent:
    if not isinstance(doc, dict):
        raise FaultConfigError(f"fault event must be a mapping, got {doc!r}")
    doc = dict(doc)
    if "at" not in doc:
        raise FaultConfigError("fault event needs an 'at' time")
    at = units.parse_time(doc.pop("at"))
    if at <= 0:
        raise FaultConfigError(
            f"fault event 'at' must be > 0 (initial conditions belong in the "
            f"graph itself), got {at} ns"
        )
    kind = str(doc.pop("kind", ""))
    if kind not in KINDS:
        raise FaultConfigError(
            f"unknown fault kind {kind!r}; expected one of {sorted(KINDS)}"
        )
    ev = {"at": at, "kind": kind}
    if kind in LINK_KINDS:
        for k in ("source", "target"):
            if k not in doc:
                raise FaultConfigError(f"{kind} event needs '{k}' (a graph node id)")
            ev[k] = int(doc.pop(k))
        if kind == "loss":
            if "loss" not in doc:
                raise FaultConfigError("loss event needs a 'loss' value in [0, 1]")
            loss = float(doc.pop("loss"))
            if not math.isfinite(loss) or not (0.0 <= loss <= 1.0):
                raise FaultConfigError(
                    f"loss event: 'loss' must be a finite value in [0, 1], got {loss!r}"
                )
            ev["loss"] = loss
        elif kind == "latency":
            if "latency" not in doc:
                raise FaultConfigError(
                    'latency event needs a \'latency\' unit string like "20 ms"'
                )
            lat = units.parse_time(doc.pop("latency"))
            if lat <= 0:
                raise FaultConfigError("latency event: 'latency' must be > 0")
            ev["latency_ns"] = lat
    elif kind == "partition":
        ev["groups"] = _parse_groups(doc.pop("groups", None))
    elif kind in HOST_KINDS:
        host = doc.pop("host", None)
        if not host:
            raise FaultConfigError(f"{kind} event needs a 'host' (hostname)")
        ev["host"] = str(host)
    # heal / backend_stall take no extra fields
    if doc:
        raise FaultConfigError(
            f"unknown keys on {kind} fault event: {sorted(doc)}"
        )
    return FaultEvent(**ev)


class FaultSchedule:
    """An ordered, validated list of fault events.

    Events are kept in ``(at, listed-order)`` order: same-instant events
    apply in the order the config lists them, which makes the cumulative
    fault state — and every table snapshot — deterministic.
    """

    def __init__(self, events: list[FaultEvent]) -> None:
        self.events = sorted(
            events, key=lambda e: e.at
        )  # Python sort is stable: listed order breaks ties

    @classmethod
    def parse(cls, raw: list) -> "FaultSchedule":
        if raw is None:
            raw = []
        if not isinstance(raw, (list, tuple)):
            raise FaultConfigError(
                f"faults.events must be a list of event mappings, got {raw!r}"
            )
        return cls([parse_event(e) for e in raw])

    def __len__(self) -> int:
        return len(self.events)
