"""Sweep result aggregation: per-scenario rows + cross-scenario
statistics, exported as the ``SWEEP_<name>-S<k>.json`` artifact.

Determinism: the aggregation is pure integer arithmetic — percentiles
are sorted-index selections (no float interpolation), outlier flags are
MAD-based integer compares — and the JSON serialization is canonical
(sorted keys, fixed separators), so running the same sweep twice
produces byte-identical artifacts.  The JAX package's ``sweep/report.py``:
the same results give the same bytes.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

# cross-scenario statistics cover every counter key seen in any
# scenario, plus the window/round totals
_DROP_KEYS = ("lane_drop_loss", "lane_drop_codel", "lane_drop_queue")


def _pct(sorted_vals: list[int], p: int) -> int:
    """Sorted-index percentile (deterministic — NO interpolation): the
    value at floor(p * (n-1) / 100)."""
    return sorted_vals[(p * (len(sorted_vals) - 1)) // 100]


def _cross_stats(values: list[int]) -> dict:
    """p50/p90/p99 + min/max + MAD outlier flags over one metric's
    per-scenario values.  A scenario is an outlier when its absolute
    deviation from the median exceeds 4x the median absolute deviation
    — or deviates at all when MAD is 0 (more than half the fleet is
    identical, so any deviation is anomalous)."""
    sv = sorted(values)
    med = _pct(sv, 50)
    devs = sorted(abs(v - med) for v in values)
    mad = _pct(devs, 50)
    outliers = [
        i
        for i, v in enumerate(values)
        if (abs(v - med) > 4 * mad if mad else v != med)
    ]
    return {
        "p50": med,
        "p90": _pct(sv, 90),
        "p99": _pct(sv, 99),
        "min": sv[0],
        "max": sv[-1],
        "outliers": outliers,
    }


def build_report(sweep, results, name: str = "sweep") -> dict:
    """The SWEEP artifact payload: one row per scenario (identity,
    counters, drop causes, netobs block) and cross-scenario statistics
    for every counter key."""
    rows = []
    for v, r in zip(sweep.variants, results):
        row = {
            "index": v.index,
            "label": v.label,
            "seed": v.seed,
            "fault_axis": v.fault_axis,
            "override_axis": v.override_axis,
            "rounds": int(r.rounds),
            "counters": {k: int(c) for k, c in sorted(r.counters.items())},
            "drops": {
                k.removeprefix("lane_drop_"): int(r.counters.get(k, 0))
                for k in _DROP_KEYS
            },
        }
        snap = sweep.engines[v.index].netobs_snapshot()
        if snap is not None:
            arrays = snap["arrays"]
            row["window_hist"] = [int(x) for x in snap["window_hist"]]
            row["netobs"] = {
                "tx_bytes": int(np.asarray(arrays["tx_bytes"]).sum()),
                "rx_bytes": int(np.asarray(arrays["rx_bytes"]).sum()),
                "throttled": int(np.asarray(arrays["throttled"]).sum()),
                "cross_shed": int(
                    np.asarray(arrays["drop_cross_shed"]).sum()
                ),
            }
        else:
            row["window_hist"] = None
            row["netobs"] = None
        rows.append(row)

    keys = sorted({k for r in results for k in r.counters})
    cross = {
        "rounds": _cross_stats([int(r.rounds) for r in results]),
    }
    for k in keys:
        cross[k] = _cross_stats([int(r.counters.get(k, 0)) for r in results])
    return {
        "name": name,
        "size": sweep.size,
        # the JAX package's name for the batched lane backend, so that
        # both packages write the same artifact
        "backend": "tpu",
        "scenarios": rows,
        "cross": cross,
    }


def artifact_name(report: dict) -> str:
    return f"SWEEP_{report['name']}-S{report['size']}"


def write_report(report: dict, out_dir) -> Path:
    """Write the artifact as ``SWEEP_<name>-S<k>.json`` under
    ``out_dir`` — canonical serialization, byte-identical run-twice."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{artifact_name(report)}.json"
    path.write_text(
        json.dumps(report, sort_keys=True, indent=2, separators=(",", ": "))
        + "\n"
    )
    return path
