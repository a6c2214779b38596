"""Carry lane tables and states across as numpy dicts.

A dict maps each field name to a numpy array — what ``np.asarray`` of a
``LaneTables``/``LaneState`` field gives, in this package or in the JAX
package.  That is how a test lifts the reference's tables and states into
the port, and compares the two field by field; the port itself never
touches JAX.  Fields the port does not carry are ignored.

Every field must arrive in the dtype the port keeps — int32, the int64
log, egress buffer and loss thresholds, the bool ``cd_dropping``,
``lane_stream``, ``lane_pcap``, ``flow_pcap`` and ``lane_external`` — and
any other dtype raises, with these mappings made explicit:

- the reference keeps its loss thresholds as ``thresh_u32`` (uint32, the
  low word) and ``thresh_all`` (bool, loss 1.0), per node pair and per
  stream endpoint (``flow_thresh_u32``/``flow_thresh_all``); the port
  keeps one int64 ``thresh``/``flow_thresh`` in
  ``core.rng.loss_threshold``'s u64 domain, since PyTorch cannot compare
  uint32.  ``thresh = 2**32`` where ``thresh_all``, else ``thresh_u32``;
- the reference's ``()`` placeholder of a field its run does not use (the
  stream fields ``q_phi``, ``q_plo``, ``stream`` without streams, the
  ``nb_*`` counters without netobs, the hybrid backend's ``egress*`` and
  ``lane_external`` off it — ``np.asarray(())`` is an empty float64
  array) is the port's empty int32 tensor;
- the reference's ``StreamState(cl, sv)`` arrives stacked, ``[2, S, F]``
  (what ``np.asarray`` makes of it), which is the port's ``stream``;
- on a tiered run ``stream`` arrives as the three arrays of the
  reference's ``TierState`` — ``(flows, q, v)``, the flows stacked as
  above — and becomes the port's ``lanes_stream.TierState``;
  ``state_to_numpy`` gives it back in that form;
- the port's lane -> endpoint-row table (``lane_ep_start``,
  ``lane_ep_rows``), which the reference has no counterpart of, is
  derived from ``flow_lanes``.
"""

from __future__ import annotations

import numpy as np
import torch

from .lanes import LaneState, LaneTables
from .lanes_stream import TierState

_DTYPES = {"cd_dropping": torch.bool, "log": torch.int64,
           "thresh": torch.int64, "flow_thresh": torch.int64,
           "lane_stream": torch.bool, "lane_pcap": torch.bool,
           "flow_pcap": torch.bool, "egress": torch.int64,
           "lane_external": torch.bool}
# fields whose placeholder (the reference's () off the hybrid backend) is
# the port's empty int32 tensor, whatever dtype the field has on it
_INT32_PLACEHOLDER = frozenset({"egress", "lane_external"})
_NP = {torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}


def _tensor(name: str, arr, device) -> torch.Tensor:
    dtype = _DTYPES.get(name, torch.int32)
    a = np.asarray(arr)
    if a.size == 0 and name in _INT32_PLACEHOLDER:
        dtype = torch.int32  # off the hybrid backend
    if a.size == 0 and a.dtype == np.float64:  # the reference's ()
        a = a.astype(_NP[dtype])
    if a.dtype != _NP[dtype]:
        raise TypeError(f"{name}: dtype {a.dtype}, expected {_NP[dtype]}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def thresh_from_split(thresh_u32, thresh_all) -> np.ndarray:
    """The reference's (uint32 low word, bool loss-1.0) pair as the port's
    int64 u64-domain threshold table."""
    low = np.asarray(thresh_u32)
    every = np.asarray(thresh_all)
    if low.dtype != np.uint32 or every.dtype != np.bool_:
        raise TypeError(
            f"thresh_u32/thresh_all: dtypes {low.dtype}/{every.dtype}, "
            "expected uint32/bool"
        )
    return np.where(every, np.int64(1) << 32, low.astype(np.int64))


def lane_endpoints(flow_lanes, n_lanes: int, s_flows: int):
    """The lane -> endpoint-row table: ``(start [N + 1], rows)``, the rows
    of lane ``l`` being ``rows[start[l]:start[l + 1]]``."""
    el = np.asarray(flow_lanes, dtype=np.int64)
    if not s_flows:
        return np.zeros(n_lanes + 1, dtype=np.int32), np.zeros(2, np.int32)
    order = np.argsort(el, kind="stable")
    start = np.searchsorted(el[order], np.arange(n_lanes + 1))
    return start.astype(np.int32), order.astype(np.int32)


def tables_from_numpy(d: dict, device="cpu", s_flows: int = 0) -> LaneTables:
    """``s_flows``: the number of stream flows (0 when no stream model is
    present, and the flow tables are placeholders)."""
    if "thresh" not in d and "thresh_u32" in d:
        d = {**d, "thresh": thresh_from_split(d["thresh_u32"], d["thresh_all"])}
    if "flow_thresh" not in d and "flow_thresh_u32" in d:
        d = {**d, "flow_thresh": thresh_from_split(d["flow_thresh_u32"],
                                                   d["flow_thresh_all"])}
    if "lane_ep_start" not in d:
        start, rows = lane_endpoints(d["flow_lanes"], len(d["node_of"]),
                                     s_flows)
        d = {**d, "lane_ep_start": start, "lane_ep_rows": rows}
    return LaneTables(**{f: _tensor(f, d[f], device) for f in LaneTables._fields})


def state_from_numpy(d: dict, device="cpu") -> LaneState:
    def field(f):
        if f == "stream" and isinstance(d[f], (tuple, list)):
            return TierState(*(_tensor(f, a, device) for a in d[f]))
        return _tensor(f, d[f], device)

    return LaneState(**{f: field(f) for f in LaneState._fields})


def state_to_numpy(s: LaneState) -> dict:
    def field(t):
        if isinstance(t, TierState):
            return tuple(a.cpu().numpy() for a in t)
        return t.cpu().numpy()

    return {f: field(getattr(s, f)) for f in LaneState._fields}
