"""The JAX package's random streams: the part of ``jax.random`` it draws
from, under its default ``threefry2x32`` PRNG with partitionable counters
(``jax_threefry_partitionable``, the default since JAX 0.5), reproduced
with integer tensor arithmetic.

A key is a ``(..., 2)`` int64 tensor holding the two uint32 words of a JAX
key (torch's ``uint32`` lacks most CUDA ops, so every add and shift is
followed by ``& 0xFFFFFFFF``).  Every function takes a leading batch of
keys, broadcast against its counters, as ``jax.vmap`` over the JAX
function would: one call draws for all of them.

Every draw gives the same bits as ``jax.random`` on the CPU, and the same
bits on the card as on the CPU: the counters are integer arithmetic and a
stable sort, and the float steps are the ones XLA's CPU backend takes,
written in operations that round the same on both devices (``+ - * /``,
the FMA of ``core/fma.py``, a float64 square root).  So ``normal`` ends in
XLA's float32 ``erf_inv`` polynomial over XLA's own ``log1p`` and ``log``
(``gumbel`` too), not torch's, which differ from XLA's and between the CPU
and the card.

The JAX sources: ``jax/_src/prng.py`` (``threefry_seed``,
``_threefry2x32_lowering``, ``iota_2x32_shape``, ``_threefry_split_foldlike``,
``threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py`` (``_uniform``, ``_shuffle``, ``_normal_real``,
``_gumbel``, ``categorical``).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import numpy as np
import torch

from repro_torch.core.fma import fma

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> tuple:
    return (int(shape),) if isinstance(shape, int) else tuple(
        int(s) for s in shape)


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as JAX builds it without x64: the seed
    is taken as int32 (its low 32 bits), so the high word is 0 and the low
    word is ``seed mod 2**32``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def as_key(key, device=None) -> torch.Tensor:
    """A key (or a batch of keys) from any array of uint32 words, e.g. a
    JAX key through ``np.asarray``: ``(..., 2)`` int64 on ``device``."""
    if isinstance(key, torch.Tensor):
        return key.to(device=device or key.device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(key).astype(np.int64), device=device)


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) & _M32) | (v >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash of the counter words ``(x0, x1)`` under the
    key words ``(k0, k1)`` (all int64 holding uint32, broadcast): 20
    rounds, a key injection every 4 with the injection's index added."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _hash_counters(key: torch.Tensor, shape: tuple
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry of ``key`` (batch ``B``) over the partitionable counters of
    ``shape``: the (hi, lo) words of each element's flat row-major index.
    Returns two ``(*B, *shape)`` int64 tensors."""
    numel = math.prod(shape)
    idx = torch.arange(numel, dtype=torch.int64, device=key.device).reshape(
        shape)
    tail = (1,) * len(shape)
    k0 = key[..., 0].reshape(key.shape[:-1] + tail)
    k1 = key[..., 1].reshape(key.shape[:-1] + tail)
    return threefry2x32(k0, k1, idx >> 32, idx & _M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(..., num, 2)``."""
    b0, b1 = _hash_counters(key, (int(num),))
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry of ``key`` on the
    counter words ``(0, data)``.  ``data`` is an int or an integer tensor
    broadcast against the keys' batch (``jax.vmap(fold_in)``)."""
    if not isinstance(data, torch.Tensor):
        data = torch.tensor(int(data), dtype=torch.int64)
    data = data.to(device=key.device, dtype=torch.int64) & _M32
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape,
                bit_width: int = 32) -> torch.Tensor:
    """``jax.random.bits(key, shape)``: ``bits1 ^ bits2`` of the hashed
    counters, kept to ``bit_width`` (32, or 8 for a 16-bit float's
    uniforms); ``(..., *shape)`` int64."""
    b0, b1 = _hash_counters(key, _shape(shape))
    return (b0 ^ b1) & ((1 << bit_width) - 1)


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` for float32
    or bfloat16: random mantissa bits under the exponent of 1 (float32: the
    top 23 of 32 bits; bfloat16: the top 7 of 8), minus 1, scaled by
    ``maxval - minval`` in ``dtype`` (one FMA with ``minval``, as XLA's CPU
    backend contracts it, rounded to ``dtype`` once), then floored at
    ``minval``."""
    if dtype == torch.float32:
        floats = ((random_bits(key, shape) >> 9) | 0x3F800000).to(
            torch.int32).view(torch.float32) - 1.0
    elif dtype == torch.bfloat16:
        floats = ((random_bits(key, shape, 8) >> 1) | 0x3F80).to(
            torch.int16).view(torch.bfloat16).float() - 1.0
    else:
        raise ValueError(f"uniform draws float32 or bfloat16, not {dtype}")
    if minval == 0.0 and maxval == 1.0:
        return floats.to(dtype)
    lo = torch.tensor(minval, dtype=dtype)
    scale = float(torch.tensor(maxval, dtype=dtype) - lo)
    out = fma(floats, scale, float(lo)).to(dtype)
    return torch.maximum(out, lo.to(out.device))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``arange(n)`` shuffled by
    ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each a split of the key and a
    STABLE sort by fresh 32-bit draws (``lax.sort_key_val`` is stable, and
    the draws tie at large n).  ``(..., n)`` int64."""
    n = int(n)
    num_rounds = int(np.ceil(3 * np.log(max(1, n))
                             / np.log(np.iinfo(np.uint32).max)))
    x = torch.arange(n, dtype=torch.int64, device=key.device).expand(
        key.shape[:-1] + (n,))
    for _ in range(num_rounds):
        keys = split(key)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1,
                           stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def _f32(v: float) -> float:
    return float(np.float32(v))


# XLA's CPU float32 ``log`` (Cephes, as Eigen's ``plog``): the mantissa
# folded into [sqrt(1/2), sqrt(2)) - 1, a degree-8 polynomial in three
# interleaved Horner chains, the exponent added back in two parts.
_LOG_P = tuple(_f32(c) for c in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG_Q1, _LOG_Q2 = _f32(-2.12194440e-4), _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)
_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def log(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log`` as XLA's CPU backend computes it (its polynomial,
    and its multiply-adds contracted into FMAs): bit-equal to ``jnp.log``
    there, and the same bits on the card, where ``torch.log`` is another
    approximation."""
    x = x.to(torch.float32)
    bits = torch.clamp(x, min=_MIN_NORMAL).view(torch.int32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [1/2, 1)
    e = 1.0 + ((bits >> 23) - 0x7F).to(torch.float32)
    below = m < _SQRTHF
    e = e - below.to(torch.float32)
    m = (m - 1.0) + torch.where(below, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    y = fma(m, _LOG_P[0], _LOG_P[1])
    y1 = fma(m, _LOG_P[3], _LOG_P[4])
    y2 = fma(m, _LOG_P[6], _LOG_P[7])
    y = fma(y, m, _LOG_P[2])
    y1 = fma(y1, m, _LOG_P[5])
    y2 = fma(y2, m, _LOG_P[8])
    y = fma(y, x3, y1)
    y = fma(y, x3, y2)
    y = fma(y, x3, _LOG_Q1 * e)
    out = (m - 0.5 * x2 + y) + _LOG_Q2 * e
    out = torch.where(x == 0, torch.full_like(out, -math.inf), out)
    out = torch.where(x == math.inf, x, out)
    return torch.where((x < 0) | torch.isnan(x), torch.full_like(
        out, math.nan), out)


# XLA's ``log1p`` (its elemental emitter): Cephes' rational approximation
# where |x| < sqrt(2) - 1, else ``log(1 + x)``.
_LOG1P_NUM = tuple(_f32(c) for c in (
    4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
    6.5787325942061044846969E0, 2.9911919328553073277375E1,
    6.0949667980987787057556E1, 5.7112963590585538103336E1,
    2.0039553499201281259648E1))
_LOG1P_DEN = tuple(_f32(c) for c in (
    1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
    2.2176239823732856465394E2, 3.0909872225312059774938E2,
    2.1642788614495947685003E2, 6.0118660497603843919306E1))
_SQRT2_MINUS_1 = _f32(0.41421356237309504880)


def _horner(x: torch.Tensor, coefficients) -> torch.Tensor:
    p = torch.full_like(x, coefficients[0])
    for c in coefficients[1:]:
        p = fma(p, x, c)
    return p


def log1p(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p`` as XLA's CPU backend computes it (bit-equal to
    ``jnp.log1p`` there; the same bits on the card)."""
    x = x.to(torch.float32)
    x2 = x * x
    small = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + fma(x2, -0.5, (x * x2) * small)
    return torch.where(x.abs() < _SQRT2_MINUS_1, small, log(x + 1.0))


# XLA's float32 ErfInv (Giles; its math library's ``ErfInv32``): two
# branches at w = -log1p(-x^2) < 5, a degree-8 polynomial in (w - 2.5) or
# (sqrt(w) - 3) by multiply-adds.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 ``lax.erf_inv`` in XLA's order of operations, with XLA's
    ``log1p`` and the polynomial's multiply-adds as FMAs, as XLA's CPU
    backend contracts them; ``+-1`` gives ``+-inf``."""
    x = x.to(torch.float32)
    w = -log1p(-x * x)
    lt = w < 5.0
    # torch's float32 sqrt on the CPU is not always correctly rounded; the
    # float64 root rounded to float32 is (53 >= 2 * 24 + 2 bits)
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    lo = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    hi = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lo[0], hi[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = fma(p, w, torch.where(lt, lo[i], hi[i]))
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_SQRT2_F32 = float(np.float32(np.sqrt(2)))
_NEXT_ABOVE_MINUS_ONE = float(np.nextafter(np.float32(-1), np.float32(0)))


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32: uniforms on
    ``(nextafter(-1, 0), 1)``, then ``sqrt(2) * erf_inv``."""
    u = uniform(key, shape, _NEXT_ABOVE_MINUS_ONE, 1.0)
    return erf_inv(u) * _SQRT2_F32


_TINY = float(np.finfo(np.float32).tiny)     # bfloat16's too


def _log_in(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``log`` of a float32 or bfloat16 tensor, rounded to its dtype
    (XLA computes a bfloat16 op in float32)."""
    return log(x.float()).to(x.dtype)


def gumbel(key: torch.Tensor, shape: Shape = (),
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, dtype)``, mode "low":
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``, each ``log``
    rounded to ``dtype``."""
    return -_log_in(-_log_in(uniform(key, shape, _TINY, 1.0, dtype)))


def categorical(key: torch.Tensor, logits: torch.Tensor,
                axis: int = -1) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis)``: the Gumbel-max draw,
    ``argmax(gumbel(key, logits.shape, logits.dtype) + logits)`` (the first
    index on ties).  One key (no batch): the gumbels span the logits'
    whole shape."""
    g = gumbel(key.to(logits.device), tuple(logits.shape), logits.dtype)
    return torch.argmax(g + logits, dim=axis)
