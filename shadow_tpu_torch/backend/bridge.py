"""Carry lane tables and states across as numpy dicts.

A dict maps each field name to a numpy array — what ``np.asarray`` of a
``LaneTables``/``LaneState`` field gives, in this package or in the JAX
package.  That is how a test lifts the reference's tables and states into
the port, and compares the two field by field; the port itself never
touches JAX.  Fields the port does not carry are ignored.
"""

from __future__ import annotations

import numpy as np
import torch

from .lanes import LaneState, LaneTables

_DTYPES = {"cd_dropping": torch.bool, "log": torch.int64}
_NP = {torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}


def _tensor(name: str, arr, device) -> torch.Tensor:
    dtype = _DTYPES.get(name, torch.int32)
    a = np.asarray(arr)
    if a.dtype != _NP[dtype]:
        raise TypeError(f"{name}: dtype {a.dtype}, expected {_NP[dtype]}")
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tables_from_numpy(d: dict, device="cpu") -> LaneTables:
    return LaneTables(**{f: _tensor(f, d[f], device) for f in LaneTables._fields})


def state_from_numpy(d: dict, device="cpu") -> LaneState:
    return LaneState(**{f: _tensor(f, d[f], device) for f in LaneState._fields})


def state_to_numpy(s: LaneState) -> dict:
    return {f: getattr(s, f).cpu().numpy() for f in LaneState._fields}
