"""Batched sweep driver: S scenarios of one shape run together, each
kernel launched once per step for all of them (``lanes._build_sweep_run``,
the counterpart of the JAX package's ``make_sweep_fn``).

The batching law, as in the JAX package's ``sweep/engine.py``: every
per-scenario quantity — the tables, the seed, the stop bound and the
whole ``LaneState`` — is that scenario's own, and a finished scenario is
a no-op in every kernel while the others run on (a per-scenario done
mask, not a global barrier), so each scenario follows exactly its serial
trajectory and the batched run equals S serial runs, bit for bit.

Fault schedules batch by SEGMENTS: every variant's epoch plan is padded
to the longest plan's length with trailing zero-length no-op rows
(``GpuEngine.segment_plan``), and the batch runs the segments one after
another, each against its per-scenario tables and stop times, through
the same batched loop.
"""

from __future__ import annotations

import dataclasses
import time as wall_time
from typing import Optional

from .. import default_device
from ..backend import kernels, lanes
from ..backend.gpu_engine import GpuEngine
from ..backend.results import SimResult
from .variants import SweepVariant, check_congruence


class SweepEngine:
    """Runs the S variants of a sweep as one batched lane program, on the
    card unless ``device="cpu"``."""

    def __init__(
        self,
        variants: list[SweepVariant],
        log_capacity: Optional[int] = None,
        device=None,
    ) -> None:
        if not variants:
            raise ValueError("sweep needs at least one variant")
        self.variants = variants
        self.device = default_device(device)
        self.launches: dict = {}
        self.states: list = []
        self.engines = [
            GpuEngine(v.cfg, log_capacity=log_capacity, device=self.device)
            for v in variants
        ]
        check_congruence(self.engines)
        # has_loss normalization: one variant with loss makes the whole
        # batch run the loss draw.  Bit-safe for loss-free scenarios: the
        # draws are threefry counters keyed on the send sequence, never
        # consumed from a positional stream, and the all-pass threshold
        # decides each of them
        any_loss = any(e.params.has_loss for e in self.engines)
        for e in self.engines:
            e.params = dataclasses.replace(e.params, has_loss=any_loss)

    @property
    def size(self) -> int:
        return len(self.variants)

    def _segment_plans(self):
        """Per-variant epoch plans, padded to one depth with trailing
        zero-length no-op rows."""
        depth = max(len(e.segment_plan()) for e in self.engines)
        return [e.segment_plan(pad_to=depth) for e in self.engines], depth

    def run(self) -> list[SimResult]:
        """Run all S scenarios; returns one SimResult per variant, in
        variant order.  ``wall_seconds`` on every result is the WHOLE
        batch's wall time.  Afterwards ``states`` holds the final lane
        states and ``launches`` each kernel's launches per batched step (on
        the card; 0 on the CPU, where the plain versions run): one,
        whatever S."""
        engines = self.engines
        states = self.states = [e.initial_state() for e in engines]
        plans, depth = self._segment_plans()
        before = {fn.__name__: fn.launches for fn in kernels.WRAPPERS}
        run_fn = lanes._build_sweep_run([e.params for e in engines],
                                        [e.tables for e in engines], states)
        engines[0]._sync()
        t0 = wall_time.perf_counter()
        for seg in range(depth):
            rows = [plan[seg] for plan in plans]
            run_fn([e.segment_tables(snap)
                    for e, (_a, _b, snap) in zip(engines, rows)],
                   [end for _a, end, _s in rows])
        engines[0]._sync()
        wall = wall_time.perf_counter() - t0
        self.launches = {
            fn.__name__: (fn.launches - before[fn.__name__]) / run_fn.steps
            for fn in kernels.WRAPPERS if fn is not kernels.rand_u32}
        return [e.collect(s, wall) for e, s in zip(engines, states)]
