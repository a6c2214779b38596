"""int32 pair arithmetic for the plain (PyTorch) versions of the lane
kernels.

The lane state keeps the JAX package's layout: times as (hi, lo) int32
pairs with value = hi * 2**31 + lo, lo in [0, 2**31); (NEVER32, NEVER32)
encodes NEVER.  These helpers are the JAX package's ``lanes_pairs.py`` on
torch tensors, so the plain versions repeat the reference's arithmetic
step by step.  The CUDA kernels join each pair to int64 in registers
instead; the kernel-versus-plain checks hold the two to the same integers.
"""

from __future__ import annotations

import torch

NEVER32 = 0x7FFFFFFF
MASK31 = 0x7FFFFFFF

# engine-guarded ceiling for pair_mod_small's modulus: every intermediate
# of the chunked reduction must fit int32
MOD_SMALL_LIMIT = 1 << 22


def pair_lt(ahi, alo, bhi, blo):
    return (ahi < bhi) | ((ahi == bhi) & (alo < blo))


def pair_ge(ahi, alo, bhi, blo):
    return ~pair_lt(ahi, alo, bhi, blo)


def pair_min_lanes(hi, lo):
    """Lexicographic min over all elements of an (hi, lo) pair array."""
    mh = hi.min()
    ml = torch.where(hi == mh, lo, NEVER32).min()
    return mh, ml


def pair_add32(hi, lo, x):
    """pair + x for 0 <= x < 2**31 (x int32 scalar or tensor)."""
    t = lo + x  # may wrap into the sign bit: that IS the carry
    return hi + (t < 0).to(torch.int32), t & MASK31


def pair_sub32(hi, lo, x):
    """pair - x for 0 <= x < 2**31; caller guarantees pair >= x."""
    t = lo - x
    return hi - (t < 0).to(torch.int32), t & MASK31


def pair_add_pair(ahi, alo, bhi, blo):
    t = alo + blo
    return ahi + bhi + (t < 0).to(torch.int32), t & MASK31


def pair_max(ahi, alo, bhi, blo):
    a_wins = pair_ge(ahi, alo, bhi, blo)
    return torch.where(a_wins, ahi, bhi), torch.where(a_wins, alo, blo)


def pair_sel(c, ahi, alo, bhi, blo):
    return torch.where(c, ahi, bhi), torch.where(c, alo, blo)


def pair_sub_clamp(ahi, alo, bhi, blo, lim):
    """max(0, min(a - b, lim)) as int32 — exact whenever the true
    difference lies in [0, lim] (lim < 2**31)."""
    d = ahi - bhi
    raw = alo - blo  # in (-2**31, 2**31)
    ge = pair_ge(ahi, alo, bhi, blo)
    lim = torch.as_tensor(lim, dtype=torch.int32, device=ahi.device)
    # d == 1 with raw < 0: value = 2**31 + raw = (raw + 1) + MASK31,
    # which cannot overflow because raw + 1 <= 0
    return torch.where(
        ~ge,
        0,
        torch.where(
            d == 0,
            torch.minimum(raw, lim),
            torch.where(
                (d == 1) & (raw < 0),
                torch.minimum((raw + 1) + MASK31, lim),
                lim,
            ),
        ),
    ).to(torch.int32)


def pair_div_pow2(hi, lo, k: int):
    """(hi, lo) >> k for static 1 <= k <= 30 (non-negative pairs)."""
    mask = (1 << k) - 1
    return hi >> k, ((hi & mask) << (31 - k)) + (lo >> k)


def pair_mul_small(hi, lo, c: int):
    """pair * c for a small static 1 <= c <= 7; caller guarantees the
    product fits the pair range (hi * c < 2**31).  lo = lh*2**16 + ll, and
    lh*c = q*2**15 + s gives lo*c = q*2**31 + s*2**16 + ll*c; the int32
    wrap of the final sum IS its one possible carry."""
    if not 1 <= c <= 7:
        raise ValueError(f"pair_mul_small: c={c} out of range")
    lh = lo >> 16
    ll = lo & 0xFFFF
    mid = lh * c
    q = mid >> 15
    s = mid & 0x7FFF
    t = (s << 16) + ll * c
    return hi * c + q + (t < 0).to(torch.int32), t & MASK31


def pair_mod_small(hi, lo, m: int):
    """``(hi * 2**31 + lo) % m`` for a STATIC modulus ``m < 2**22`` in
    int32: ``v % m = ((hi % m) * (2**31 % m) + lo % m) % m``, the product
    folded 8 bits at a time so every intermediate stays below 2**31."""
    if m >= MOD_SMALL_LIMIT:
        raise ValueError(f"pair_mod_small: modulus {m} >= {MOD_SMALL_LIMIT}")
    big_m = (1 << 31) % m
    a = hi % m
    r = torch.zeros_like(a)
    for shift in (24, 16, 8, 0):
        chunk = (big_m >> shift) & 0xFF
        r = ((r << 8) + a * chunk) % m
    return (r + lo % m) % m
