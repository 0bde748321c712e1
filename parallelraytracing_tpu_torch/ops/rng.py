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
  per-frame scalar seeds (``ops.rays.frame_stream_seeds``);
  ``threefry2x32`` also takes keys as word arrays and ``randint_keys``
  draws for many keys at once (``ops.rays.frame_stream_seeds_block``).
- threefry2x32 on tensors, for the megakernel engine's streams (the JAX
  jnp engines draw from threefry per element): ``fold_in`` and ``split``
  also take keys as (..., 2) tensors, and ``random_bits``, ``uniform``
  and ``normal`` equal ``jax.random.bits`` / ``uniform`` / ``normal``
  under the partitionable threefry (element i of a draw hashes the
  counter pair (0, i)).  ``bits_at`` draws with a key per element, so a
  batch of rays from many keys takes one call.  ``uniform`` is bit-equal;
  ``normal`` is ``erf_inv`` of a uniform in (-1, 1) times sqrt 2, with
  XLA's float32 ``ErfInv`` polynomial, its log1p and the float32 log of
  its CPU backend (Cephes, as Eigen writes it) copied with their
  multiply-adds fused: about 15 draws in a million still differ from
  JAX on the CPU by 1 ulp (a last-ulp difference of XLA's log).
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
    (x0, x1) under key (k0, k1); uint32 in, uint32 out.  The key words
    may be arrays, one key an element, broadcast against the counters."""
    with np.errstate(over="ignore"):
        k0, k1 = np.asarray(key[0], np.uint32), np.asarray(key[1], np.uint32)
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


def as_key(key, device=None) -> torch.Tensor:
    """A key as an int64 (..., 2) tensor of uint32 words."""
    if isinstance(key, torch.Tensor):
        return key
    return torch.tensor([int(key[0]) & MASK32, int(key[1]) & MASK32],
                        dtype=torch.int64, device=device)


def _modular_draw(higher, lower, minval: int, maxval: int):
    """JAX's two-word modular draw in [minval, maxval) of 32-bit words
    `higher` and `lower` (ints, or uint64 arrays: no product passes
    2**62), with its uint32 wrap-around in the multiplier."""
    span = maxval - minval
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = (((higher % span) * multiplier) & MASK32) + lower % span
    return minval + (offset & MASK32) % span


def randint(key, minval: int, maxval: int) -> int:
    """``jax.random.randint(key, (), minval, maxval, int32)`` for
    0 <= minval < maxval <= 2**31 - 1."""
    hi_key, lo_key = split(key)
    return _modular_draw(_random_bits32(hi_key), _random_bits32(lo_key),
                         minval, maxval)


def split_keys(key) -> Tuple[np.ndarray, np.ndarray]:
    """``split(key, 2)`` of (k0, k1) uint32 word arrays: word arrays of
    shape (2, *k0.shape), [0] the first keys, [1] the second."""
    i = np.arange(2, dtype=np.uint32).reshape((2,) + (1,) * np.ndim(key[0]))
    return threefry2x32(key, 0, i)  # key i hashes (0, i)


def randint_keys(key, minval: int, maxval: int) -> np.ndarray:
    """``randint`` of each key of (k0, k1) uint32 word arrays at once:
    int64 draws, element i that of key (k0[i], k1[i])."""
    a, b = threefry2x32(split_keys(key), 0, 0)  # both halves at once
    words = (a ^ b).astype(np.uint64)
    return _modular_draw(words[0], words[1], minval, maxval).astype(np.int64)


# ---------------------------------------------------------------------------
# threefry2x32 on tensors (int64 holding uint32 words)
# ---------------------------------------------------------------------------

def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32_t(k0, k1, x0, x1):
    """``threefry2x32`` on int64 tensors of uint32 words (broadcast)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    a = (x0 + k0) & MASK32
    b = (x1 + k1) & MASK32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & MASK32
            b = _rotl_t(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return a, b


def fold_in_t(key: torch.Tensor, data) -> torch.Tensor:
    """``fold_in`` of (..., 2) key tensors with `data` (an int or an
    int64 tensor broadcast against the keys' leading shape)."""
    data = torch.as_tensor(data, dtype=torch.int64, device=key.device)
    a, b = threefry2x32_t(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data & MASK32)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def split_t(key: torch.Tensor, num: int = 2):
    """``split`` of (..., 2) key tensors: a list of `num` keys alike."""
    return [fold_in_t(key, i) for i in range(num)]


def bits_at(key: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """32 random bits of element `counter` (int64) of a draw under `key`
    ((..., 2), broadcast against counter): the two words of
    threefry(key, (0, counter)) xor-ed, as ``jax.random.bits`` computes
    element i of a draw of fewer than 2**32 elements."""
    a, b = threefry2x32_t(key[..., 0], key[..., 1], torch.zeros_like(counter),
                          counter)
    return a ^ b


def random_bits(key, shape, device=None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 words."""
    key = as_key(key, device)
    n = 1
    for s in shape:
        n *= int(s)
    counter = torch.arange(n, dtype=torch.int64, device=key.device)
    return bits_at(key, counter).reshape(tuple(shape))


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """JAX's float32 uniform of 32 random bits: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, scaled to [minval, maxval)
    and clamped below at minval."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp_min(f * span + lo, lo)


def uniform(key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)``, bit-equal."""
    return uniform_from_bits(random_bits(key, shape, device))


def fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (a fused multiply-add; the
    float64 product of two float32 values is exact)."""
    return (a.double() * b + c).float()


#: Cephes' float32 log polynomial (XLA's CPU log, as Eigen's plog)
_LOG_P = tuple(float(np.float32(v)) for v in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = float(np.float32(-2.12194440e-4))
_LOG_Q2 = float(np.float32(0.693359375))


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """float32 log of XLA's CPU backend: frexp, a shift to
    [sqrt(1/2), sqrt(2)) and Cephes' degree-8 polynomial in three
    parts, its multiply-adds fused."""
    t = torch.clamp_min(x, float(np.float32(1.1754943508222875e-38)))
    words = t.view(torch.int32)
    e = ((words >> 23) - 126).to(torch.float32)
    t = ((words & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = t < float(np.float32(0.707106781186547524))
    shift = torch.where(low, t, 0.0)
    t = t - 1.0
    e = e - low.to(torch.float32)
    t = t + shift
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = fma(t, p[0], p[1])
    y1 = fma(t, p[3], p[4])
    y2 = fma(t, p[6], p[7])
    y = fma(y, t, p[2])
    y1 = fma(y1, t, p[5])
    y2 = fma(y2, t, p[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = y * x3
    y = y + _LOG_Q1 * e
    t = t - 0.5 * x2
    t = t + y
    return t + _LOG_Q2 * e


#: XLA's log1p: Cephes' rational form below sqrt 2 - 1, highest power first
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    def horner(coeffs):
        p = torch.zeros_like(x)
        for c in coeffs:
            p = fma(p, x, float(np.float32(c)))
        return p

    x2 = x * x
    small = (x * x2) * (horner(_LOG1P_NUM) / horner(_LOG1P_DEN))
    small = x + fma(x2, -0.5, small)
    return torch.where(torch.abs(x) < 0.41421356237309504880, small,
                       _xla_log(x + 1.0))


#: XLA's float32 ErfInv (Giles 2010): w < 5 and w >= 5 coefficients
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` of float32 x in [-1, 1] (XLA's polynomial;
    sqrt correctly rounded, as XLA's is)."""
    w = -_xla_log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5,
                    torch.sqrt(w.double()).to(torch.float32) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).to(torch.float32)
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, float(np.float32(a)), float(np.float32(b)))
        p = fma(p, w, c.to(torch.float32))
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


#: the lower end of JAX's normal's uniform: the float after -1
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 standard normal of 32 random bits."""
    return _SQRT2 * erf_inv(uniform_from_bits(bits, _NORMAL_LO, 1.0))


def normal(key, shape, device=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` (see the module note
    on its last ulp)."""
    return normal_from_bits(random_bits(key, shape, device))
