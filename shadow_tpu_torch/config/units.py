"""Typed SI quantities for configuration values.

User-facing parity with the reference's ``utility/units.rs``: config fields
accept strings like ``"10 ms"`` or ``"1 Gbit"`` (space optional) or bare
numbers.  Everything normalizes to integers — nanoseconds, bits/sec —
because integer quantities are the determinism currency of the whole
simulator (see core/time.py).
"""

from __future__ import annotations

import re

from ..core import time as stime

_NUM_RE = re.compile(r"^\s*([0-9]+(?:\.[0-9]+)?)\s*([a-zA-Zμ]*)\s*$")

_TIME_UNITS = {
    "": stime.NANOS_PER_SEC,  # bare numbers in time positions mean seconds
    "ns": 1,
    "nsec": 1,
    "us": stime.NANOS_PER_MICRO,
    "usec": stime.NANOS_PER_MICRO,
    "μs": stime.NANOS_PER_MICRO,
    "ms": stime.NANOS_PER_MILLI,
    "msec": stime.NANOS_PER_MILLI,
    "s": stime.NANOS_PER_SEC,
    "sec": stime.NANOS_PER_SEC,
    "second": stime.NANOS_PER_SEC,
    "seconds": stime.NANOS_PER_SEC,
    "m": stime.NANOS_PER_MIN,
    "min": stime.NANOS_PER_MIN,
    "h": stime.NANOS_PER_HOUR,
    "hr": stime.NANOS_PER_HOUR,
    "hour": stime.NANOS_PER_HOUR,
}

_SI = {"": 1, "K": 10**3, "M": 10**6, "G": 10**9, "T": 10**12}
_IEC = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40}
# "k" is the canonical lowercase SI kilo ("300kbit"); accept it everywhere K is
for _d in (_SI, _IEC):
    for _k in [k for k in _d if k.startswith("K")]:
        _d["k" + _k[1:]] = _d[_k]


def _bit_units() -> dict[str, int]:
    units: dict[str, int] = {}
    for p, mult in _SI.items():
        units[p + "bit"] = mult
        units[p + "b"] = mult
    for p, mult in _IEC.items():
        units[p + "bit"] = mult
        units[p + "b"] = mult
    return units


_BIT_UNITS = _bit_units()


class UnitError(ValueError):
    pass


def _split(value: str) -> tuple[float, str]:
    m = _NUM_RE.match(value)
    if not m:
        raise UnitError(f"cannot parse quantity {value!r}")
    return float(m.group(1)), m.group(2)


def parse_time(value: str | int | float) -> int:
    """Parse a time quantity to integer nanoseconds.  Bare numbers are
    seconds (matching the reference's config convention, e.g. ``stop_time:
    10s`` / ``10``)."""
    if isinstance(value, (int, float)):
        return stime.from_secs(value)
    num, unit = _split(value)
    # case-sensitivity doesn't matter for time units; normalize (but keep μ)
    unit_l = unit.lower() if unit != "μs" else unit
    if unit_l not in _TIME_UNITS:
        raise UnitError(f"unknown time unit {unit!r} in {value!r}")
    scale = _TIME_UNITS[unit_l]
    if isinstance(num, float) and num != int(num):
        return round(num * scale)
    return int(num) * scale


def parse_bandwidth(value: str | int) -> int:
    """Parse a bandwidth quantity to bits/second.  Accepts ``"1 Gbit"``
    (per-second implied, as in the reference's host bandwidth fields) and
    explicit ``"10 Mbit"`` etc.; bare integers are bits/second."""
    if isinstance(value, int):
        return value
    num, unit = _split(value)
    if unit.endswith("ps"):  # "Mbps" -> "Mb", "bps" -> "b"
        unit = unit[:-2]
    if unit not in _BIT_UNITS:
        raise UnitError(f"unknown bandwidth unit {unit!r} in {value!r}")
    scale = _BIT_UNITS[unit]
    if isinstance(num, float) and num != int(num):
        return round(num * scale)
    return int(num) * scale
