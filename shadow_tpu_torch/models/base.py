"""Application models (the simulated workloads): registry and arguments.

A process entry of the config names a model by ``path`` and configures it
with ``--key value`` args.  The lane engine reads each model's parameters
from the instance :func:`create_model` returns; the behaviour itself is
the lane law in ``backend/lanes.py``.
"""

from __future__ import annotations

from typing import Any, Callable

from ..config.options import LaneCompatError

_REGISTRY: dict[str, Callable[..., Any]] = {}


def register_model(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def create_model(path: str, args: list[str]) -> Any:
    """Instantiate a model from a process ``path`` + ``args``.  Paths that
    name no model of this slice (other built-in models, real binaries)
    raise :class:`LaneCompatError`."""
    if path in _REGISTRY:
        return _REGISTRY[path].from_args(args)  # type: ignore[attr-defined]
    raise LaneCompatError(
        f"process {path!r} is not ported yet: this slice runs "
        f"{sorted(_REGISTRY)} only (use the shadow_tpu package)"
    )


def parse_kv_args(args: list[str], known: set[str] | None = None) -> dict[str, str]:
    """Parse ``--key value`` / ``--key=value`` model args.  When ``known``
    is given, unknown keys are rejected (typos must not silently fall back
    to defaults)."""
    out: dict[str, str] = {}
    i = 0
    while i < len(args):
        a = args[i]
        if not a.startswith("--"):
            raise ValueError(f"model args must be --key value pairs, got {a!r}")
        if "=" in a:
            k, _, v = a[2:].partition("=")
            out[k] = v
            i += 1
        else:
            if i + 1 >= len(args):
                raise ValueError(f"missing value for model arg {a!r}")
            out[a[2:]] = args[i + 1]
            i += 2
    if known is not None:
        unknown = set(out) - known
        if unknown:
            raise ValueError(
                f"unknown model args {sorted('--' + k for k in unknown)} "
                f"(known: {sorted('--' + k for k in known)})"
            )
    return out
