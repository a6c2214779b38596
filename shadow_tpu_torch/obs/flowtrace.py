"""Flowtrace: per-flow packet-lifecycle events of sampled flows.

The JAX package's ``obs/flowtrace.py`` on the port: the event taxonomy,
the seeded flow hash and its sampling threshold, the decoding of the
device ring's rows, the canonical order both sides of a parity comparison
are held in, and the ``FLOWS_*.json`` report with its burst attribution,
the Chrome-trace flow arrows and the run-control ``flows`` lines.  The
lane kernels record the events on the device (``LaneParams.flowtrace``)
into a bounded ``[FL, FT_COLS]`` int32 ring that never wraps;
``GpuEngine.flowtrace_snapshot`` decodes it.

An event is eight integers::

    (t_ns, window_end_ns, kind, src, dst, seq, size, aux)

``kind`` is one of the ``FT_*`` codes; ``aux`` carries the drop cause of
an ``FT_DROP`` and the bucket direction of an ``FT_TB_WAIT``.  ``seq`` is
the source's send sequence number, so the stages of one wire packet join
on ``(src, dst, seq)``.  A flow ``(src, dst)`` is traced iff
``flow_hash(src, dst, 0, seed) < thresh`` with ``thresh = floor(sample *
2**32)``; ``sample >= 1`` traces every flow without evaluating the hash.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Optional

import numpy as np

from .netobs import HIST_BUCKETS, hist_bucket

SCHEMA_VERSION = 1

# lifecycle event kinds
FT_SEND = 0         # wire send accepted at the source (at the stimulus time)
FT_TB_WAIT = 1      # token-bucket deferral (at the bucket departure)
FT_QUEUE_ENTER = 2  # committed to the wire (at the arrival time)
FT_DROP = 3         # dropped; aux = cause
FT_RETRANSMIT = 4   # send stage of a retransmitted stream segment
FT_DELIVERY = 5     # delivered at the destination (at the delivery time)

KIND_NAMES = {
    FT_SEND: "send",
    FT_TB_WAIT: "tb_wait",
    FT_QUEUE_ENTER: "queue_enter",
    FT_DROP: "drop",
    FT_RETRANSMIT: "retransmit",
    FT_DELIVERY: "delivery",
}

# FT_DROP causes (the netobs taxonomy)
CAUSE_LOSS = 0
CAUSE_CODEL = 1
CAUSE_QUEUE = 2
CAUSE_CROSS_SHED = 3
CAUSE_RETRY_GIVEUP = 4

CAUSE_NAMES = {
    CAUSE_LOSS: "loss",
    CAUSE_CODEL: "codel",
    CAUSE_QUEUE: "queue",
    CAUSE_CROSS_SHED: "cross_shed",
    CAUSE_RETRY_GIVEUP: "retry_giveup",
}

# FT_TB_WAIT: which bucket deferred
TB_UP = 0
TB_DN = 1

#: columns of a ring row: t_hi, t_lo, window-end hi, lo, kind, src, dst,
#: seq, size, aux — times as the lane kernels' bit-31 (hi, lo) pairs
FT_COLS = 10

_PAIR_BASE = 1 << 31
_MASK32 = 0xFFFFFFFF
# odd multipliers of the mix, then the murmur3 fmix32 finalizer
_M_SRC = 2654435761
_M_DST = 2246822519
_M_FID = 3266489917
_M_SEED = 668265263


def flow_hash(src: int, dst: int, fid: int, seed: int) -> int:
    """The u32 sampling hash of a flow (the lane kernels' ``flow_hash``,
    bit for bit: every step reduces mod 2**32)."""
    h = (src * _M_SRC + dst * _M_DST + fid * _M_FID + seed * _M_SEED) & _MASK32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK32
    h ^= h >> 16
    return h


def sample_thresh(sample: float) -> tuple[int, bool]:
    """``(thresh_u32, all_pass)`` for a sampling fraction: ``sample >= 1``
    traces every flow, ``sample <= 0`` none."""
    if sample >= 1.0:
        return 0, True
    if sample <= 0.0:
        return 0, False
    return int(sample * float(1 << 32)) & _MASK32, False


def rows_to_events(rows) -> list[tuple]:
    """Ring rows (``[n, FT_COLS]`` int32) as event tuples, in ring order."""
    r = np.asarray(rows, dtype=np.int64).reshape(-1, FT_COLS)
    out = np.empty((r.shape[0], 8), dtype=np.int64)
    out[:, 0] = r[:, 0] * _PAIR_BASE + r[:, 1]
    out[:, 1] = r[:, 2] * _PAIR_BASE + r[:, 3]
    out[:, 2:] = r[:, 4:]
    return list(map(tuple, out.tolist()))


def canonical_events(raw, capacity: int) -> tuple[list[tuple], int]:
    """The export law: sorted by the whole tuple, then cut at
    ``capacity``, the excess counted as lost.  Two streams are compared
    only where neither side lost an event."""
    ev = sorted(tuple(e) for e in raw)
    lost = max(0, len(ev) - capacity)
    return (ev[:capacity] if lost else ev), lost


def window_index(events) -> tuple[list[int], dict[int, int]]:
    """Dense window indexing: the sorted distinct window stamps present
    in the (canonical) event stream, plus the stamp -> index map.  Both
    backends derive it from the events themselves, so identical streams
    get identical indices."""
    stamps = sorted({e[1] for e in events})
    return stamps, {we: i for i, we in enumerate(stamps)}


def host_class(hostname: str) -> str:
    """Flow-class key: the hostname with its replica digits stripped
    (``client12`` -> ``client``)."""
    return re.sub(r"\d+$", "", hostname) or hostname


def _agg(values: list[int]) -> dict:
    return {
        "count": len(values),
        "sum": sum(values),
        "min": min(values) if values else 0,
        "max": max(values) if values else 0,
    }


TOP_CLASSES = 5


def build_report(
    run_id: str,
    backend: str,
    seed: int,
    hostnames: list[str],
    events: list[tuple],
    events_lost: int,
    thresh: int,
    all_pass: bool,
    capacity: int,
    extra: Optional[dict] = None,
) -> dict:
    """The FLOWS document (schema in docs/observability.md): the
    canonical event stream, per-flow lifecycle breakdowns, and the
    burst-attribution ranking.  Integer content only, deterministic
    ordering — run-twice artifacts must diff byte-identical."""
    windows, widx = window_index(events)

    def name(h: int) -> str:
        return hostnames[h] if 0 <= h < len(hostnames) else f"host{h}"

    # -- per-flow lifecycle joins on (src, dst, seq) ----------------------
    flows: dict[tuple[int, int], dict] = {}
    stages: dict[tuple[int, int, int], dict[int, int]] = {}
    for t, we, kind, src, dst, seq, size, aux in events:
        fl = flows.get((src, dst))
        if fl is None:
            fl = flows[(src, dst)] = {
                "sends": 0, "retransmits": 0, "delivered": 0,
                "bytes": 0,
                "drops": {c: 0 for c in CAUSE_NAMES.values()},
            }
        if kind in (FT_SEND, FT_RETRANSMIT):
            fl["sends"] += 1
            fl["bytes"] += size
            if kind == FT_RETRANSMIT:
                fl["retransmits"] += 1
        elif kind == FT_DELIVERY:
            fl["delivered"] += 1
        elif kind == FT_DROP:
            fl["drops"][CAUSE_NAMES.get(aux, "loss")] += 1
        st = stages.setdefault((src, dst, seq), {})
        # one event per (packet, kind) except TB_WAIT (up vs dn): key
        # the wait stages by direction so the joins below stay exact
        st[(kind, aux) if kind == FT_TB_WAIT else (kind, 0)] = t
    per_flow_lat: dict[tuple[int, int], list[int]] = {}
    per_flow_qd: dict[tuple[int, int], list[int]] = {}
    per_flow_tbw: dict[tuple[int, int], list[int]] = {}
    for (src, dst, seq), st in stages.items():
        send_t = st.get((FT_SEND, 0), st.get((FT_RETRANSMIT, 0)))
        deliv_t = st.get((FT_DELIVERY, 0))
        enter_t = st.get((FT_QUEUE_ENTER, 0))
        if send_t is not None and deliv_t is not None:
            per_flow_lat.setdefault((src, dst), []).append(deliv_t - send_t)
        if enter_t is not None and deliv_t is not None:
            per_flow_qd.setdefault((src, dst), []).append(deliv_t - enter_t)
        up_t = st.get((FT_TB_WAIT, TB_UP))
        if up_t is not None and send_t is not None:
            per_flow_tbw.setdefault((src, dst), []).append(up_t - send_t)
        dn_t = st.get((FT_TB_WAIT, TB_DN))
        if dn_t is not None and enter_t is not None:
            per_flow_tbw.setdefault((src, dst), []).append(dn_t - enter_t)
    flow_docs = {}
    for (src, dst), fl in sorted(flows.items()):
        flow_docs[f"{name(src)}->{name(dst)}"] = {
            "src": src,
            "dst": dst,
            "class": f"{host_class(name(src))}->{host_class(name(dst))}",
            **fl,
            "latency_ns": _agg(per_flow_lat.get((src, dst), [])),
            "queue_delay_ns": _agg(per_flow_qd.get((src, dst), [])),
            "tb_wait_ns": _agg(per_flow_tbw.get((src, dst), [])),
        }

    # -- burst attribution: flow classes per window-occupancy bucket ------
    # Arrival events (delivery | codel drop) are the flowtrace twin of
    # netobs's PACKET pops: exactly one per arrived packet.  Buckets use
    # the same log2 law; with sample < 1 the counts (hence buckets) are
    # of the sampled subpopulation — exact attribution needs sample=1.
    win_counts: dict[int, int] = {}
    win_class: dict[int, dict[str, int]] = {}
    for t, we, kind, src, dst, seq, size, aux in events:
        if kind == FT_DELIVERY or (kind == FT_DROP and aux == CAUSE_CODEL):
            w = widx[we]
            win_counts[w] = win_counts.get(w, 0) + 1
            cls = f"{host_class(name(src))}->{host_class(name(dst))}"
            cc = win_class.setdefault(w, {})
            cc[cls] = cc.get(cls, 0) + 1
    bucket_windows: dict[int, int] = {}
    bucket_class: dict[int, dict[str, int]] = {}
    for w, cnt in win_counts.items():
        b = hist_bucket(cnt)
        bucket_windows[b] = bucket_windows.get(b, 0) + 1
        bc = bucket_class.setdefault(b, {})
        for cls, n in win_class[w].items():
            bc[cls] = bc.get(cls, 0) + n
    buckets = []
    for b in range(HIST_BUCKETS):
        if b not in bucket_windows:
            continue
        ranked = sorted(
            bucket_class[b].items(), key=lambda kv: (-kv[1], kv[0])
        )
        buckets.append({
            "bucket": b,
            "windows": bucket_windows[b],
            "top_classes": [
                {"class": cls, "arrivals": n}
                for cls, n in ranked[:TOP_CLASSES]
            ],
        })

    kinds = {}
    for e in events:
        k = KIND_NAMES.get(e[2], str(e[2]))
        kinds[k] = kinds.get(k, 0) + 1
    doc: dict = {
        "schema": SCHEMA_VERSION,
        "run_id": run_id,
        "backend": backend,
        "seed": int(seed),
        "sample_thresh": int(thresh),
        "sample_all": bool(all_pass),
        "capacity": int(capacity),
        "events_lost": int(events_lost),
        "num_events": len(events),
        "events_by_kind": kinds,
        "num_flows": len(flows),
        "windows": [int(w) for w in windows],
        "events": [list(e) for e in events],
        "flows": flow_docs,
        "burst_attribution": {
            "scheme": "log2-packet-arrivals",
            "buckets": buckets,
        },
    }
    if extra:
        doc.update(extra)
    return doc


def write_report(path: str | Path, report: dict) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2, sort_keys=True) + "\n")
    return path


def render_flows(tracer, events, hostnames: list[str]) -> int:
    """Chrome-trace flow arrows (``Tracer.flow``): one s->f arrow per
    delivered sampled packet, placed on the simulated-time axis (1 sim
    ns = 1e-9 trace seconds, so Perfetto shows sim microseconds).
    Returns the number of arrows emitted."""
    sends: dict[tuple[int, int, int], int] = {}
    for t, we, kind, src, dst, seq, size, aux in events:
        if kind in (FT_SEND, FT_RETRANSMIT):
            sends[(src, dst, seq)] = t
    n = 0
    for t, we, kind, src, dst, seq, size, aux in events:
        if kind != FT_DELIVERY:
            continue
        t0 = sends.get((src, dst, seq))
        if t0 is None:
            continue
        def name(h):
            return hostnames[h] if 0 <= h < len(hostnames) else f"host{h}"
        label = f"{name(src)}->{name(dst)}#{seq}"
        fid = flow_hash(src, dst, seq, 0)
        tracer.flow("s", fid, label, "flowtrace", tracer.t0 + t0 * 1e-9)
        tracer.flow("f", fid, label, "flowtrace", tracer.t0 + t * 1e-9)
        n += 1
    return n


def summary_line(events, events_lost: int) -> str:
    """The one-line run-control summary (``stats`` fold + ``flows``
    verb header)."""
    pairs = {(e[3], e[4]) for e in events}
    sends = sum(1 for e in events if e[2] in (FT_SEND, FT_RETRANSMIT))
    deliv = sum(1 for e in events if e[2] == FT_DELIVERY)
    drops = sum(1 for e in events if e[2] == FT_DROP)
    return (
        f"flows: sampled_pairs={len(pairs)} events={len(events)}"
        f" sends={sends} delivered={deliv} drops={drops}"
        f" events_lost={events_lost}"
    )


def snapshot_lines(
    events, events_lost: int, hostnames: list[str],
    limit: int = 10, host: Optional[str] = None,
) -> list[str]:
    """Human-readable snapshot (the run-control ``flows`` verb): the
    summary line plus the busiest sampled flows.  ``host`` restricts the
    flow listing to pairs touching that hostname."""
    lines = [summary_line(events, events_lost)]
    per_pair: dict[tuple[int, int], int] = {}
    for e in events:
        per_pair[(e[3], e[4])] = per_pair.get((e[3], e[4]), 0) + 1
    ranked = sorted(per_pair.items(), key=lambda kv: (-kv[1], kv[0]))

    def name(h):
        return hostnames[h] if 0 <= h < len(hostnames) else f"host{h}"

    if host is not None:
        ranked = [
            kv for kv in ranked
            if host in (name(kv[0][0]), name(kv[0][1]))
        ]
    for (src, dst), n in ranked[:limit]:
        lines.append(f"  {name(src)}->{name(dst)}: {n} events")
    return lines
