"""threefry2x32 in torch, reproducing ``jax.random`` bit for bit.

The DP path draws its coordinates with Gumbel noise from a JAX key chain;
holding the port to the JAX package coordinate for coordinate needs the same
bits.  This module reproduces JAX 0.9's defaults: the threefry2x32 PRNG,
``jax_threefry_partitionable=True`` and 32-bit mode (x64 off).

* ``PRNGKey(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]``.
* ``split(key, n)`` is ``_threefry_split_foldlike``: key i of the result is
  ``threefry2x32(key, (0, i))``, both output words.
* ``fold_in(key, data)`` is ``threefry2x32(key, (0, data))``: JAX seeds a key
  from the uint32 ``data`` as ``[0, data]`` and hashes it under ``key``.
* ``random_bits(key, shape)``: element at flat index c is ``o0 ^ o1`` of
  ``threefry2x32(key, (c >> 32, c & 0xFFFFFFFF))``.
* ``uniform``: ``(bits >> 9) | 0x3F800000`` viewed as float32, minus 1, then
  scaled to ``[minval, maxval)`` and max-clamped at ``minval``.
* ``gumbel``: ``-log(-log(u))`` with u uniform on ``[tiny, 1)``.

Keys are int64 tensors holding uint32 values; the arithmetic is int64 with
``& 0xFFFFFFFF`` masks because torch's uint32 support is thin.
``threefry2x32`` takes Python ints or int64 tensors alike, so a key chain is
computed on the host without launching anything.  The CUDA draw kernel
(``kernels/csrc/threefry.cuh``) repeats the same rounds in uint32.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(torch.finfo(torch.float32).tiny)


def _rotl(x, r: int):
    # x < 2^32 and r <= 29, so x << r stays below 2^61 in int64
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block: key (k0, k1), counter (x0, x1) → (o0, o1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """Raw key ``[seed >> 32, seed & 0xFFFFFFFF]`` (int64 tensor on the CPU)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64)


def _key_ints(key) -> Tuple[int, int]:
    k0, k1 = (int(k) for k in key)
    return k0, k1


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` → (num, 2) int64 tensor."""
    k0, k1 = _key_ints(key)
    lo = torch.arange(num, dtype=torch.int64)
    o0, o1 = threefry2x32(k0, k1, torch.zeros_like(lo), lo)
    return torch.stack([o0, o1], dim=1)


def split2(key) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``split(key)`` as two (k0, k1) int pairs, without a tensor op."""
    k0, k1 = _key_ints(key)
    return threefry2x32(k0, k1, 0, 0), threefry2x32(k0, k1, 0, 1)


def fold_in(key, data: int) -> Tuple[int, int]:
    """``jax.random.fold_in(key, data)`` as a (k0, k1) int pair."""
    k0, k1 = _key_ints(key)
    return threefry2x32(k0, k1, 0, int(data) & MASK)


def key_chain(key, steps: int) -> Tuple[torch.Tensor, List[Tuple[int, int]]]:
    """The scan's key stream: ``key, sel_t = split(key)`` for t = 1..steps.

    Returns the key after ``steps`` splits and the ``steps`` selection keys.
    """
    cur = _key_ints(key)
    sel = []
    for _ in range(steps):
        cur, s = split2(cur)
        sel.append(s)
    return torch.tensor(cur, dtype=torch.int64), sel


def random_bits(key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """32 random bits per element (int64 tensor of uint32 values)."""
    k0, k1 = _key_ints(key)
    n = 1
    for s in shape:
        n *= int(s)
    c = torch.arange(n, dtype=torch.int64, device=device)
    o0, o1 = threefry2x32(k0, k1, c >> 32, c & MASK)
    return (o0 ^ o1).reshape(tuple(shape))


def uniform(key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """float32 uniform on ``[minval, maxval)``, as ``jax.random.uniform``."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """float32 standard Gumbel, as ``jax.random.gumbel`` (mode "low")."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0, device)))
