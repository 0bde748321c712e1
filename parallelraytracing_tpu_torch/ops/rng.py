"""Counter-based random streams, bit-for-bit those of the JAX package.

Two generators, neither with state:

- PCG (``pcg_hash`` / ``uniform01``): the per-pixel hash of the fused
  kernel (``parallelraytracing_tpu/ops/pallas_trace.py`` ``_pcg_hash`` /
  ``_uniform01``, the OptiX backend's pcg_hash).  On tensors it runs in
  int64 with a 32-bit mask, because PyTorch's uint32 arithmetic is
  partial; the CUDA kernel computes the same words in native uint32.
- threefry2x32 on the host (numpy): ``prng_key``, ``fold_in``, ``split``
  and ``randint`` reproduce ``jax.random.PRNGKey``, ``fold_in``, ``split``
  and ``randint(key, (), 0, 2**31 - 1, int32)`` exactly (threefry2x32
  with partitionable key derivation, JAX's default).  They derive the two
  per-frame scalar seeds (``ops.rays.frame_stream_seeds``); the render
  path itself needs no other randomness.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
#: the Weyl increment that salts each draw of a stream
SALT_STEP = 0x9E3779B9
#: the per-bounce stride of a ray's stream (``rng_base + depth * this``)
DEPTH_STEP = 0x85EBCA6B


def salt_word(salt: int) -> int:
    return (salt * SALT_STEP) & MASK32


def pcg_hash(x: torch.Tensor) -> torch.Tensor:
    """PCG output permutation on int64 tensors holding uint32 words."""
    state = (x * 747796405 + 2891336453) & MASK32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    return (word >> 22) ^ word


def uniform01(counter: torch.Tensor, salt: int) -> torch.Tensor:
    """[0,1) float32 uniforms from the top 24 bits of pcg(counter ^ salt)."""
    bits = pcg_hash(counter ^ salt_word(salt))
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


# ---------------------------------------------------------------------------
# threefry2x32 (host, numpy uint32)
# ---------------------------------------------------------------------------

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 block cipher (20 rounds) of counter words
    (x0, x1) under key (k0, k1); uint32 in, uint32 out."""
    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(key[0]), np.uint32(key[1])
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: (0, seed)."""
    return (0, int(seed) & MASK32)


def fold_in(key, data: int) -> Tuple[int, int]:
    """``jax.random.fold_in``: hash the counter pair (0, data)."""
    a, b = threefry2x32(key, np.uint32(0), np.uint32(int(data) & MASK32))
    return (int(a), int(b))


def split(key, num: int = 2):
    """``jax.random.split`` (partitionable): key i hashes counters (0, i)."""
    a, b = threefry2x32(key, np.zeros(num, np.uint32),
                        np.arange(num, dtype=np.uint32))
    return [(int(a[i]), int(b[i])) for i in range(num)]


def _random_bits32(key) -> int:
    """``random_bits(key, 32, ())``: the two output words xor-ed."""
    a, b = threefry2x32(key, np.uint32(0), np.uint32(0))
    return int(a ^ b)


def randint(key, minval: int, maxval: int) -> int:
    """``jax.random.randint(key, (), minval, maxval, int32)`` for
    0 <= minval < maxval <= 2**31 - 1: JAX's two-word modular draw, with
    its uint32 wrap-around in the multiplier."""
    hi_key, lo_key = split(key)
    higher, lower = _random_bits32(hi_key), _random_bits32(lo_key)
    span = maxval - minval
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = (((higher % span) * multiplier) & MASK32) + lower % span
    return minval + (offset & MASK32) % span
