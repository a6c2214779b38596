"""The netobs telemetry plane: per-host counters and the window histogram.

The JAX package's ``obs/netobs.py``, trimmed to what the lane engine and a
report need: the counter catalog, the drop-cause taxonomy, the log2 bucket
law of the per-window packet-arrival histogram, the report document, its
``NETOBS_*.json`` file and the human-readable snapshot.  The lane kernels accumulate the counters on
the device (``LaneParams.netobs``); ``GpuEngine.netobs_snapshot`` folds
them into the per-host arrays of this schema, equal counter for counter
to the reference's and the CPU oracle's.

Per host: packets ``sent`` / ``delivered``, bytes by direction, drops by
cause (``loss`` — the link's Bernoulli table, ``codel`` — CoDel's
decision, ``queue`` — lane-queue overflow, ``cross_shed`` — the exchange's
width, ``retry_giveup``), token-bucket ``throttled`` events (charges that
waited for a refill) and ``retransmits`` of completed stream flows.  Per
run: windows by the floor(log2) of their popped PACKET count; windows
without a packet are skipped.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

SCHEMA_VERSION = 1

#: must match backend.lanes.NB_HIST_BUCKETS
HIST_BUCKETS = 24

#: the per-host counter catalog, in report order
COUNTERS = (
    "sent",
    "delivered",
    "tx_bytes",
    "rx_bytes",
    "drop_loss",
    "drop_codel",
    "drop_queue",
    "drop_cross_shed",
    "throttled",
    "retransmits",
    "retry_giveup",
)

#: the drop-cause taxonomy
DROP_CAUSES = ("loss", "codel", "queue", "cross_shed", "retry_giveup")

TOP_TALKERS = 10
#: the per-host breakdown is embedded only up to this host count
PER_HOST_CAP = 1024


def hist_bucket(count: int) -> int:
    """floor(log2(count)) clamped to the bucket range (count >= 1): the
    law of the device's window flush (``lanes.ilog2_i32``)."""
    return min(max(int(count), 1).bit_length() - 1, HIST_BUCKETS - 1)


def empty_arrays(n_hosts: int) -> dict[str, np.ndarray]:
    """A fresh all-zero set of counter arrays."""
    return {k: np.zeros(n_hosts, dtype=np.int64) for k in COUNTERS}


def totals(arrays: dict[str, np.ndarray]) -> dict[str, int]:
    return {k: int(arrays[k].sum()) for k in COUNTERS}


def build_report(
    run_id: str,
    backend: str,
    seed: int,
    hostnames: list[str],
    arrays: dict[str, np.ndarray],
    window_hist,
    log_lost: int = 0,
    extra: Optional[dict] = None,
) -> dict:
    """The NETOBS document: integers only, in a fixed order, so two runs
    of one configuration give byte-identical documents."""
    n = len(hostnames)
    tot = totals(arrays)
    drops = {
        "loss": tot["drop_loss"],
        "codel": tot["drop_codel"],
        "queue": tot["drop_queue"],
        "cross_shed": tot["drop_cross_shed"],
        "retry_giveup": tot["retry_giveup"],
    }
    hist = [int(v) for v in np.asarray(window_hist)]
    # top talkers: most tx bytes, then most packets, host id breaks ties
    order = sorted(
        range(n),
        key=lambda i: (
            -int(arrays["tx_bytes"][i]), -int(arrays["sent"][i]), i
        ),
    )
    talkers = [
        {
            "host": hostnames[i],
            "sent": int(arrays["sent"][i]),
            "tx_bytes": int(arrays["tx_bytes"][i]),
            "delivered": int(arrays["delivered"][i]),
            "rx_bytes": int(arrays["rx_bytes"][i]),
        }
        for i in order[:TOP_TALKERS]
        if int(arrays["sent"][i]) or int(arrays["tx_bytes"][i])
    ]
    wire_drops = (
        tot["drop_loss"] + tot["drop_codel"] + tot["drop_queue"]
        + tot["drop_cross_shed"]
    )
    doc: dict = {
        "schema": SCHEMA_VERSION,
        "run_id": run_id,
        "backend": backend,
        "seed": int(seed),
        "num_hosts": n,
        "totals": tot,
        "drops_by_cause": drops,
        "drop_total": sum(drops.values()),
        # conservation: sent == delivered + wire drops + in flight at the
        # stop time
        "in_flight": tot["sent"] - tot["delivered"] - wire_drops,
        "log_lost": int(log_lost),
        "window_hist": {
            "scheme": "log2-packet-arrivals",
            "buckets": hist,
            "windows": sum(hist),
        },
        "top_talkers": talkers,
    }
    if n <= PER_HOST_CAP:
        doc["per_host"] = {
            hostnames[i]: {k: int(arrays[k][i]) for k in COUNTERS}
            for i in range(n)
        }
    if extra:
        doc.update(extra)
    return doc


def write_report(path: str | Path, report: dict) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
    return path


def snapshot_lines(
    arrays: dict[str, np.ndarray],
    window_hist,
    hostnames: list[str],
    host: Optional[str] = None,
) -> list[str]:
    """A human-readable snapshot: totals, drops, the histogram, and one
    host's counters when ``host`` is given."""
    tot = totals(arrays)
    lines = [
        "net totals: "
        + " ".join(f"{k}={tot[k]}" for k in (
            "sent", "delivered", "tx_bytes", "rx_bytes"))
    ]
    lines.append(
        "drops: "
        + " ".join(f"{k}={tot[k]}" for k in (
            "drop_loss", "drop_codel", "drop_queue", "drop_cross_shed",
            "retry_giveup"))
        + f" throttled={tot['throttled']} retransmits={tot['retransmits']}"
    )
    hist = [int(v) for v in np.asarray(window_hist)]
    top = max((i for i, v in enumerate(hist) if v), default=-1)
    lines.append(
        "window hist (log2 packet arrivals): "
        + (" ".join(f"b{i}={hist[i]}" for i in range(top + 1))
           if top >= 0 else "no windows yet")
    )
    if host is not None:
        if host not in hostnames:
            lines.append(f"unknown host {host!r}")
        else:
            i = hostnames.index(host)
            lines.append(
                f"{host}: "
                + " ".join(f"{k}={int(arrays[k][i])}" for k in COUNTERS)
            )
    return lines
