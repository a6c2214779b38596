"""Fleet sweeps: S independent scenario instances run as one batched lane
program on one card.

The variant compiler (:mod:`variants`) expands a base scenario and a
sweep spec (seed, fault-schedule and override axes) into S configs of one
shape, the batched driver (:mod:`engine`) runs their lane states with
each kernel launched once per step for all S, and the aggregator
(:mod:`report`) turns the per-scenario results into the
``SWEEP_<name>-S<k>.json`` artifact with cross-scenario percentiles and
outlier flags.

The correctness law: an S-batched run equals S serial runs, scenario by
scenario, bit for bit.
"""

from .engine import SweepEngine
from .report import build_report, write_report
from .variants import (
    SweepCongruenceError,
    SweepSpec,
    SweepVariant,
    expand_variants,
)

__all__ = [
    "SweepCongruenceError",
    "SweepEngine",
    "SweepSpec",
    "SweepVariant",
    "build_report",
    "expand_variants",
    "write_report",
]
