"""The port's component laws against the JAX reference, exactly.

Seeded numpy grids go through ``shadow_tpu.backend.lanes.bucket_charge_vec``
/ ``codel_offer_arrays`` and their ``shadow_tpu_torch`` twins; every output
must be equal (integer arithmetic: the tolerance is exact equality).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shadow_tpu.backend import lanes as ref
from shadow_tpu_torch.backend import lanes as port
from shadow_tpu_torch.backend import lanes_pairs as lp
from shadow_tpu_torch.net import codel as codel_mod
from shadow_tpu_torch.net.token_bucket import bucket_params

INTERVAL = 1_000_000
M = 4096


def _pair(v):
    return (v >> 31).astype(np.int32), (v & 0x7FFFFFFF).astype(np.int32)


def _both(fn_ref, fn_port, *args):
    out_ref = fn_ref(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                       for a in args])
    out_port = fn_port(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                         else a for a in args])
    for i, (a, b) in enumerate(zip(out_ref, out_port)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f"output {i}")


@pytest.mark.parametrize("case", ["mixed", "saturated", "wait"])
def test_bucket_charge_matches_reference(case):
    """Exact refill inside the k_full horizon, the saturated refill and
    grid realignment beyond it, and the token-wait branch."""
    rng = np.random.default_rng(7)
    bw = rng.choice([2_000_000, 10_000_000, 1_000_000_000, 0], M,
                    p=[0.3, 0.3, 0.3, 0.1])
    par = np.array([bucket_params(int(b)) if b else (0, 12192) for b in bw])
    rate, burst = par[:, 0].astype(np.int32), par[:, 1].astype(np.int32)
    # the engine's horizon; unlimited (rate 0) lanes never refill
    kfull = np.where(rate > 0, burst // np.maximum(rate, 1) + 1, 1).astype(np.int32)
    kfi = (kfull * INTERVAL).astype(np.int32)
    t = 5_000_000_000 + rng.integers(0, 50_000_000, M)
    back = {"mixed": [-300, -5, 0, 3], "saturated": [-5000, -400],
            "wait": [0, 2]}[case]
    nr = INTERVAL * (t // INTERVAL + rng.choice(back, M))
    ld = t + rng.choice([-1_000_000, 0, 4_000_000], M)
    tokens = rng.integers(0, burst + 1).astype(np.int32)
    if case == "wait":
        tokens = (tokens // 50).astype(np.int32)
    bits = ((rng.integers(28, 1500, M) + 24) * 8).astype(np.int32)
    active = rng.random(M) < 0.8
    _both(ref.bucket_charge_vec, port.bucket_charge_vec,
          tokens, *_pair(nr), *_pair(ld), rate, burst, kfull, kfi,
          *_pair(t), bits, active, INTERVAL)


def test_codel_offer_matches_reference():
    """Every branch of the CoDel state machine: unset/above/below, entering
    and staying in the dropping state, drop-count clamp at the table end."""
    rng = np.random.default_rng(11)
    td = 5_000_000_000 + rng.integers(0, 400_000_000, M)
    unset = rng.random(M) < 0.3
    fat = td + rng.integers(-250_000_000, 50_000_000, M)
    fat_hi, fat_lo = _pair(fat)
    fat_hi = np.where(unset, port.CD_UNSET, fat_hi).astype(np.int32)
    fat_lo = np.where(unset, 0, fat_lo).astype(np.int32)
    dn = td + rng.integers(-300_000_000, 200_000_000, M)
    dcount = rng.integers(0, 1100, M).astype(np.int32)
    dropping = rng.random(M) < 0.5
    sojourn = rng.choice([0, 5_000_000, 10_000_000, 60_000_000, 0x7FFFFFFF],
                         M).astype(np.int32)
    active = rng.random(M) < 0.8
    div = np.array(codel_mod.CODEL_DIV, dtype=np.int32)
    _both(ref.codel_offer_arrays, port.codel_offer_arrays,
          fat_hi, fat_lo, *_pair(dn), dcount, dropping, *_pair(td), sojourn,
          active, div)


def test_pair_arithmetic_exact():
    """Twin of the reference's pair-helper property check, on torch
    tensors: mul (with the carry that once corrupted RTO timing), div by
    powers of two and the chunked mod, against Python bignums."""
    import random

    rng = random.Random(7)
    cases = [(0, 306839551, 7), (0, 1431699455, 3)]
    for _ in range(20_000):
        c = rng.randint(1, 7)
        v = rng.randint(0, ((1 << 31) // c - 1) << 31 | lp.MASK31)
        cases.append((v >> 31, v & lp.MASK31, c))
    his = torch.tensor([a for a, _b, _c in cases], dtype=torch.int32)
    los = torch.tensor([b for _a, b, _c in cases], dtype=torch.int32)
    cs = np.array([c for _a, _b, c in cases])
    vs = his.to(torch.int64) * (1 << 31) + los.to(torch.int64)
    for cval in range(1, 8):
        mask = torch.from_numpy(cs == cval)
        h, lo = lp.pair_mul_small(his[mask], los[mask], cval)
        got = h.to(torch.int64) * (1 << 31) + lo.to(torch.int64)
        assert torch.equal(got, vs[mask] * cval)
        assert bool((lo >= 0).all())
    for k in (1, 2, 3, 8, 30):
        dh, dl = lp.pair_div_pow2(his, los, k)
        got = dh.to(torch.int64) * (1 << 31) + dl.to(torch.int64)
        assert torch.equal(got, vs >> k)
    for m in (3, 1_000_000, (1 << 22) - 1):
        assert torch.equal(lp.pair_mod_small(his, los, m).to(torch.int64), vs % m)
