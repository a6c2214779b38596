"""Counter-based deterministic RNG (Threefry-2x32, 20 rounds).

The JAX package's ``core/rng.py`` law, on PyTorch tensors: every host owns
streams keyed by ``(master_seed, stream)`` and indexed by a counter, so a
batched engine can draw out of order and still give the scalar oracle's
bits.  The lane engine draws with it for packet loss (``LOSS_STREAM``,
counter = the send's sequence number) and for phold's peer choice
(``APP_STREAM``, counter = the lane's app-draw count).

The CPU engine and the hybrid engine's host side (``backend/cpu_engine.py``)
draw one loss per packet and one app draw per phold hop: for them the same
function runs on Python ints (``rand_u32_int``), since a tensor op per
packet would dominate the syscall plane.

PyTorch has no ``+``, ``<<``, ``>>`` or ``<`` for ``torch.uint32`` on the
CPU, so every 32-bit word here is an int64 tensor holding a value in
``[0, 2**32)``, and each add and shift is masked back to 32 bits.  The CUDA
kernels compute the same function on ``uint32_t`` (``csrc/lanes.cu``).

Stream-id conventions (one place, so engines cannot disagree):

- ``stream = host_id | LOSS_STREAM`` : per-packet Bernoulli loss decisions
- ``stream = host_id | APP_STREAM``  : application draws (phold peer picks)
"""

from __future__ import annotations

import torch

# high bits or'd into the stream id to separate draw purposes
LOSS_STREAM = 1 << 30
APP_STREAM = 2 << 30

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u32(x):
    """``x`` taken mod 2**32: a Python int stays an int (the host-side
    path), an integer tensor becomes int64 words."""
    if isinstance(x, int):
        return x & M32
    return torch.as_tensor(x).to(torch.int64) & M32


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k0, k1, c0, c1):
    """Threefry-2x32, 20 rounds.  Inputs are 32-bit words (ints or integer
    tensors, taken mod 2**32); returns the two output words, each in
    ``[0, 2**32)``: Python ints when every input is an int (the host-side
    path: one draw costs no tensor op), else int64 tensors of the
    broadcast shape."""
    ks0, ks1 = _u32(k0), _u32(k1)
    ks2 = ks0 ^ ks1 ^ _PARITY
    x0 = (_u32(c0) + ks0) & M32
    x1 = (_u32(c1) + ks1) & M32
    schedule = (
        (_ROTATIONS[0], ks1, ks2),
        (_ROTATIONS[1], ks2, ks0),
        (_ROTATIONS[0], ks0, ks1),
        (_ROTATIONS[1], ks1, ks2),
        (_ROTATIONS[0], ks2, ks0),
    )
    for i, (rots, add0, add1) in enumerate(schedule):
        for r in rots:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + add0) & M32
        x1 = (x1 + add1 + (i + 1)) & M32
    return x0, x1


def split_seed(seed: int) -> tuple[int, int]:
    """The master seed as its (lo, hi) 32-bit key words (taken mod 2**64)."""
    seed &= (1 << 64) - 1
    return seed & M32, seed >> 32


def rand_u32_pair(seed: int, stream, counter) -> tuple[torch.Tensor, torch.Tensor]:
    """Both output words for each (stream, counter); shapes broadcast.
    ``counter`` may use all 64 bits (int64 tensors: the low 63)."""
    s_lo, s_hi = split_seed(seed)
    counter = torch.as_tensor(counter).to(torch.int64)
    return threefry2x32(s_lo, _u32(stream) ^ s_hi, counter & M32,
                        (counter >> 32) & M32)


def rand_u32(seed: int, stream, counter) -> torch.Tensor:
    """One uniform 32-bit draw per (stream, counter), as int64 words."""
    return rand_u32_pair(seed, stream, counter)[0]


def rand_u32_int(seed: int, stream: int, counter: int) -> int:
    """The host-side draw: :func:`rand_u32` of one (stream, counter) pair on
    Python ints (``counter`` may use all 64 bits), as an int in
    ``[0, 2**32)``."""
    s_lo, s_hi = split_seed(seed)
    counter &= (1 << 64) - 1
    return threefry2x32(s_lo, (stream & M32) ^ s_hi, counter & M32,
                        counter >> 32)[0]


def rand_u32_words(seed_lo, seed_hi, stream, counter) -> torch.Tensor:
    """The lane engine's draw from explicit key words: counter word
    ``c0 = counter mod 2**32`` and ``c1 = 0``.  Equal to :func:`rand_u32`
    for counters below 2**32.  The plain version of the ``rand_u32`` kernel
    (``backend/kernels.py``)."""
    return threefry2x32(seed_lo, _u32(stream) ^ _u32(seed_hi), counter, 0)[0]


def as_i32(x: torch.Tensor) -> torch.Tensor:
    """32-bit words in ``[0, 2**32)`` as int32 tensors of the same bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def u32_below(u, n) -> torch.Tensor:
    """Map a uniform 32-bit draw to ``[0, n)`` by the multiply-shift trick
    ``(u * n) >> 32``; exact in int64 for ``n < 2**31``.  On Python ints
    (the host-side path) the result is an int."""
    if isinstance(u, int) and isinstance(n, int):
        return ((u & M32) * n) >> 32
    return (_u32(u) * torch.as_tensor(n).to(torch.int64)) >> 32


def loss_threshold(packet_loss: float) -> int:
    """A loss probability as the Bernoulli drop threshold: drop iff the
    draw is below it.  The domain is u64: ``packet_loss = 1.0`` maps to
    ``2**32``, above every 32-bit draw, so it always drops."""
    if packet_loss <= 0.0:
        return 0
    if packet_loss >= 1.0:
        return 1 << 32
    return int(packet_loss * 4294967296.0)


def host_seed(master_seed: int, host_id: int) -> int:
    """Per-host 64-bit sub-seed (a splitmix64 finaliser over the master
    seed and the host id): the seed of a managed process's shim-side
    generator."""
    x = (master_seed ^ (host_id * 0x9E3779B97F4A7C15)) & ((1 << 64) - 1)
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & ((1 << 64) - 1)
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & ((1 << 64) - 1)
    return x ^ (x >> 31)
