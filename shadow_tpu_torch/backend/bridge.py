"""Carry lane tables and states across as numpy dicts.

A dict maps each field name to a numpy array — what ``np.asarray`` of a
``LaneTables``/``LaneState`` field gives, in this package or in the JAX
package.  That is how a test lifts the reference's tables and states into
the port, and compares the two field by field; the port itself never
touches JAX.  Fields the port does not carry are ignored.

Every field must arrive in the dtype the port keeps — int32, the int64
log and loss thresholds, the bool ``cd_dropping`` — and any other dtype
raises, with one mapping made explicit: the reference keeps its loss
thresholds as ``thresh_u32`` (uint32, the low word) and ``thresh_all``
(bool, loss 1.0); the port keeps one int64 ``thresh`` in
``core.rng.loss_threshold``'s u64 domain, since PyTorch cannot compare
uint32.  ``thresh = 2**32`` where ``thresh_all``, else ``thresh_u32``.
"""

from __future__ import annotations

import numpy as np
import torch

from .lanes import LaneState, LaneTables

_DTYPES = {"cd_dropping": torch.bool, "log": torch.int64,
           "thresh": torch.int64}
_NP = {torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}


def _tensor(name: str, arr, device) -> torch.Tensor:
    dtype = _DTYPES.get(name, torch.int32)
    a = np.asarray(arr)
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


def tables_from_numpy(d: dict, device="cpu") -> LaneTables:
    if "thresh" not in d and "thresh_u32" in d:
        d = {**d, "thresh": thresh_from_split(d["thresh_u32"], d["thresh_all"])}
    return LaneTables(**{f: _tensor(f, d[f], device) for f in LaneTables._fields})


def state_from_numpy(d: dict, device="cpu") -> LaneState:
    return LaneState(**{f: _tensor(f, d[f], device) for f in LaneState._fields})


def state_to_numpy(s: LaneState) -> dict:
    return {f: getattr(s, f).cpu().numpy() for f in LaneState._fields}
