"""Run-twice determinism check: the reference's regression gate as a library.

The JAX package's ``engine/determinism.py`` on the port.  The reference
proves bit-identical replay by running the same config twice and diffing
host RNG outputs and packet orderings with a CMake script
(src/test/determinism/CMakeLists.txt:1-45, determinism1_compare.cmake).
Here the same property is a first-class API: :func:`determinism_check`
runs a config twice in fresh engines (on the card, or on the CPU with
``device="cpu"``) and compares the canonical event log (the total event
order) and the merged counters.  The CLI exposes it as
``--determinism-check``.

Any unsynchronized ordering, uncounted RNG draw, wall-clock leak or race
between kernel threads shows up as a diff.
"""

from __future__ import annotations

import copy
import dataclasses

from ..config.options import ConfigOptions


@dataclasses.dataclass
class DeterminismReport:
    identical: bool
    records: int
    first_diff_index: int | None = None
    first_diff: tuple | None = None
    counter_diffs: list[str] = dataclasses.field(default_factory=list)

    def describe(self) -> str:
        if self.identical:
            return (
                f"determinism check PASSED: {self.records} event records "
                "bit-identical across two runs"
            )
        lines = ["determinism check FAILED:"]
        if self.first_diff_index is not None:
            a, b = self.first_diff
            lines.append(
                f"  first event-log divergence at record {self.first_diff_index}:"
            )
            lines.append(f"    run1: {a}")
            lines.append(f"    run2: {b}")
        for d in self.counter_diffs:
            lines.append(f"  counter mismatch: {d}")
        return "\n".join(lines)


def _run_once(cfg: ConfigOptions, device=None):
    # fresh engine per run; deep-copied config so engines can't share
    # mutable state (host lists, process args) across runs
    cfg = copy.deepcopy(cfg)
    if cfg.experimental.network_backend == "tpu":
        from ..backend.gpu_engine import GpuEngine
        from ..backend.hybrid import make_hybrid_engine
        from ..models.base import config_has_managed

        if config_has_managed(cfg):
            # managed binaries: the hybrid engine owns this config (the
            # facade's choice), the syscall worker processes included
            return make_hybrid_engine(cfg, device=device).run()
        return GpuEngine(cfg, device=device).run(mode="device")
    from ..backend.cpu_engine import CpuEngine

    return CpuEngine(cfg).run()


def compare_results(r1, r2) -> DeterminismReport:
    t1, t2 = r1.log_tuples(), r2.log_tuples()
    report = DeterminismReport(identical=True, records=len(t1))
    if t1 != t2:
        report.identical = False
        n = min(len(t1), len(t2))
        for i in range(n):
            if t1[i] != t2[i]:
                report.first_diff_index = i
                report.first_diff = (t1[i], t2[i])
                break
        else:  # one log is a strict prefix of the other
            report.first_diff_index = n
            report.first_diff = (
                t1[n] if len(t1) > n else "<end>",
                t2[n] if len(t2) > n else "<end>",
            )
    keys = set(r1.counters) | set(r2.counters)
    for k in sorted(keys):
        v1, v2 = r1.counters.get(k), r2.counters.get(k)
        if v1 != v2:
            report.identical = False
            report.counter_diffs.append(f"{k}: run1={v1} run2={v2}")
    return report


def determinism_check(cfg: ConfigOptions, device=None) -> DeterminismReport:
    """Run ``cfg`` twice and compare event orderings + counters."""
    return compare_results(_run_once(cfg, device), _run_once(cfg, device))
