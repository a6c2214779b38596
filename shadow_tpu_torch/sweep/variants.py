"""Sweep variant compiler: base scenario + sweep spec -> S congruent
config instances.

A sweep spec is up to three axes, combined as a Cartesian product in a
fixed (seeds-outermost) order:

- ``seeds``: values for ``general.seed`` (the per-scenario threefry
  master key, which each scenario's ``LaneBufs`` carries);
- ``faults``: fault SCHEDULES (each entry a ``faults.events`` list in
  the config format; ``[]`` = no faults) — latency/loss/partition
  variation rides this axis because each scenario's epoch tables are its
  own;
- ``overrides``: dotted-key config override dicts
  (:meth:`ConfigOptions.apply_overrides`) for knobs that do not change
  the launch shapes.

Congruence: one batched launch of each kernel must serve all S variants,
so every variant's static surface — the LaneParams dataclass (minus the
per-scenario seed), and the device tables' shapes and dtypes — must be
identical.  :func:`check_congruence` raises :class:`SweepCongruenceError`
naming the offending field otherwise; notably a config-level latency
override changes the static ``runahead`` and is rejected (put latency
variation on the fault axis instead), and ``backend_stall`` schedules
are rejected (a batched scenario cannot raise mid-run).

The JAX package's ``sweep/variants.py``, over the port's ``LaneParams``
and ``LaneTables``.
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
from typing import Any, Optional

from ..config.options import ConfigOptions


class SweepCongruenceError(ValueError):
    """The sweep variants cannot share one batched launch."""


@dataclasses.dataclass(frozen=True)
class SweepVariant:
    """One expanded scenario instance of a sweep batch."""

    index: int
    seed: int
    fault_axis: int  # index into spec.faults (0 when the axis is absent)
    override_axis: int  # index into spec.overrides
    cfg: ConfigOptions

    @property
    def label(self) -> str:
        return f"seed{self.seed}-f{self.fault_axis}-o{self.override_axis}"


@dataclasses.dataclass
class SweepSpec:
    """The sweep axes.  Absent axes contribute one identity element."""

    name: str = "sweep"
    seeds: Optional[list[int]] = None
    faults: Optional[list[list[dict]]] = None
    overrides: Optional[list[dict]] = None

    @classmethod
    def from_dict(cls, doc: dict[str, Any]) -> "SweepSpec":
        doc = dict(doc)
        spec = cls(
            name=str(doc.pop("name", "sweep")),
            seeds=doc.pop("seeds", None),
            faults=doc.pop("faults", None),
            overrides=doc.pop("overrides", None),
        )
        if doc:
            raise SweepCongruenceError(
                f"unknown sweep spec keys: {sorted(doc)}"
            )
        if spec.seeds is not None:
            spec.seeds = [int(s) for s in spec.seeds]
        return spec

    @classmethod
    def from_yaml(cls, text: str) -> "SweepSpec":
        import yaml

        return cls.from_dict(yaml.safe_load(text) or {})

    @classmethod
    def seed_grid(cls, base_seed: int, size: int, name: str = "sweep") -> "SweepSpec":
        """The ``experimental.sweep_size`` shorthand: seeds
        ``base_seed .. base_seed + size - 1``."""
        return cls(name=name, seeds=[base_seed + i for i in range(size)])

    @property
    def size(self) -> int:
        return (
            max(len(self.seeds or ()), 1)
            * max(len(self.faults or ()), 1)
            * max(len(self.overrides or ()), 1)
        )


def expand_variants(
    base: ConfigOptions, spec: SweepSpec
) -> list[SweepVariant]:
    """Expand the spec against ``base`` into S validated configs, in the
    deterministic product order (seeds outermost, then faults, then
    overrides)."""
    seeds = spec.seeds if spec.seeds else [base.general.seed]
    fault_axes = spec.faults if spec.faults is not None else [None]
    override_axes = spec.overrides if spec.overrides is not None else [{}]
    variants = []
    for idx, (seed, (fi, events), (oi, ovr)) in enumerate(
        itertools.product(
            seeds, enumerate(fault_axes), enumerate(override_axes)
        )
    ):
        cfg = copy.deepcopy(base)
        cfg.general.seed = int(seed)
        if events is not None:
            cfg.faults.events = copy.deepcopy(list(events))
        if ovr:
            cfg.apply_overrides(dict(ovr))
        cfg.validate()
        _reject_stalls(cfg, idx)
        variants.append(
            SweepVariant(
                index=idx, seed=int(seed), fault_axis=fi,
                override_axis=oi, cfg=cfg,
            )
        )
    return variants


def _reject_stalls(cfg: ConfigOptions, idx: int) -> None:
    for ev in cfg.faults.events:
        if isinstance(ev, dict) and ev.get("kind") == "backend_stall":
            raise SweepCongruenceError(
                f"variant {idx}: backend_stall fault events cannot be "
                "swept (a batched scenario cannot raise mid-run); "
                "run stall-failover scenarios serially"
            )


def _normalized_params(p):
    """The static surface of LaneParams: the seed is per scenario (its
    ``LaneBufs``), has_loss is normalized to the batch OR by the engine
    (bit-safe — loss draws are counter-keyed on the send sequence, never
    consumed positionally), and flow_seed only binds when flowtrace is on
    (it salts the flow sampling hash)."""
    kw = {"seed": 0, "has_loss": False}
    if not p.flowtrace:
        kw["flow_seed"] = 0
    return dataclasses.replace(p, **kw)


def _table_signature(tb):
    return tuple((f, tuple(t.shape), t.dtype) for f, t in tb._asdict().items())


def check_congruence(engines) -> None:
    """Validate that one batched launch serves every engine of the batch:
    equal normalized LaneParams (names the differing fields otherwise) and
    equal device-table shapes and dtypes."""
    ref = engines[0]
    ref_p = _normalized_params(ref.params)
    ref_sig = _table_signature(ref.tables)
    for i, eng in enumerate(engines[1:], start=1):
        if eng.params.flowtrace and eng.params.flow_seed != ref.params.flow_seed:
            raise SweepCongruenceError(
                f"variant {i}: flowtrace is on and the flow sampling "
                "seed (= general.seed) differs from variant 0 — the "
                "sampled flow set is part of the launch's static surface, so "
                "seed grids cannot batch with flowtrace enabled"
            )
        p = _normalized_params(eng.params)
        if p != ref_p:
            diffs = [
                f.name
                for f in dataclasses.fields(p)
                if getattr(p, f.name) != getattr(ref_p, f.name)
            ]
            raise SweepCongruenceError(
                f"variant {i} is not shape-congruent with variant 0: "
                f"static LaneParams fields differ: {diffs} (config-"
                "level latency changes move the static runahead — put "
                "latency/loss variation on the fault axis instead)"
            )
        if _table_signature(eng.tables) != ref_sig:
            raise SweepCongruenceError(
                f"variant {i}: device-table shapes/dtypes differ from "
                "variant 0 (different topology or flow set) — sweep "
                "variants must share one launch shape"
            )
