"""JAX's default random keys (threefry2x32) in torch, bit for bit.

The JAX package draws its synthetic rooms from ``jax.random.key(seed)``
through a tree of ``split`` / ``fold_in`` calls. Threefry is counter-based,
so the same draws come out of a few vectorised integer ops on any device;
this module reproduces ``jax.random`` 0.9 with ``jax_threefry_partitionable``
on (its default):

- a key is ``[..., 2]`` of uint32 words; here an int64 tensor holding them
  (CUDA lacks most uint32 ops), masked to 32 bits after every add/shift;
- ``split(key, n)[i]`` hashes the counter pair ``(i >> 32, i & mask)``;
  ``fold_in(key, d)`` hashes ``(0, d)``; 32-bit ``random_bits`` of shape
  ``s`` hash the row-major index pair over ``s`` and xor the two words;
- every function takes keys of any leading shape ``[..., 2]`` and returns
  ``[..., *shape]``, so one call draws for many keys at once.

``uniform`` builds float32 from the top 23 bits as JAX does (mantissa of
a number in [1, 2), minus 1), scales by ``maxval - minval`` and adds
``minval`` in one rounding (``fma``: XLA's CPU backend contracts the two),
and clamps below at ``minval``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = int | Sequence[int]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (shape,) if isinstance(shape, int) else tuple(shape)


def key(seed: int, device: str | torch.device = "cpu") -> torch.Tensor:
    """``jax.random.key(seed)``'s data: ``[0, seed]`` as uint32 words (a
    32-bit seed; negative seeds wrap as in JAX)."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) of the counter words
    ``(x1, x2)`` under the key words ``(k1, k2)``, all broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + k1) & MASK
    x2 = (x2 + k2) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x1 = (x1 + x2) & MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x1, x2


def _hash(keys: torch.Tensor, shape: Tuple[int, ...]
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both cipher words of every row-major counter of ``shape`` under
    every key: ``[..., *shape]`` each."""
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    idx = idx.reshape(shape)
    lead = keys.shape[:-1]
    view = lead + (1,) * len(shape)
    k1 = keys[..., 0].reshape(view)
    k2 = keys[..., 1].reshape(view)
    return threefry2x32(k1, k2, idx >> 32, idx & MASK)


def split(keys: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split``: ``[..., *num, 2]`` new keys."""
    b1, b2 = _hash(keys, _shape(num))
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys: torch.Tensor, data: int | torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in``: ``data`` (an int, or a tensor broadcast
    against the keys' leading shape) as a uint32 word."""
    d = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & MASK
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits`` at 32 bits: ``[..., *shape]`` words in int64."""
    b1, b2 = _hash(keys, _shape(shape))
    return b1 ^ b2


def _as_f32(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=ref.device)


def _f64(x) -> torch.Tensor | float:
    if torch.is_tensor(x):
        return x.double()
    return float(torch.tensor(x, dtype=torch.float32))


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU backend contracts
    it (numbers are first rounded to float32, as JAX's weak types are):
    the float32 product is exact in float64, so the one rounding is the
    float64 sum's (exact too while the operands' exponents lie within six
    binades, as in every range drawn here)."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def uniform(keys: torch.Tensor, shape: Shape = (), minval=0.0,
            maxval=1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 on [minval, maxval).
    ``minval`` / ``maxval`` are numbers or float32 tensors broadcast
    against the result ``[..., *shape]``."""
    bits = random_bits(keys, shape)
    one = (bits >> 9) | 0x3F800000      # 1.m, m the top 23 bits
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _as_f32(minval, floats), _as_f32(maxval, floats)
    return torch.maximum(lo, fma(floats, hi - lo, lo))


def normal(keys: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: a uniform on
    ``[nextafter(-1, 0), 1)`` (the same bits as JAX's), then
    ``sqrt(2) * erfinv(u)``. ``torch.erfinv`` is not XLA's polynomial, so
    the last bits may differ from JAX's draws."""
    lo = torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)).item()
    u = uniform(keys, shape, lo, 1.0)
    return torch.erfinv(u) * _as_f32(2.0 ** 0.5, u)


def randint(keys: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32 on [minval, maxval): two words per
    value reduced modulo the span as JAX does. Returns int64."""
    k = split(keys)
    hi = random_bits(k[..., 0, :], shape)
    lo = random_bits(k[..., 1, :], shape)
    span = max(maxval - minval, 1) & MASK
    mult = (2 ** 16) % span
    mult = (mult * mult) % span
    off = (((hi % span) * mult) & MASK) + (lo % span)
    return minval + (off & MASK) % span


def choice(keys: torch.Tensor, a: torch.Tensor, p: Sequence[float]
           ) -> torch.Tensor:
    """``jax.random.choice(key, a, (), p=p)`` (with replacement): one
    element of ``a`` per key, by inverse CDF over the float32 cumulative
    ``p``."""
    cum = torch.cumsum(torch.tensor(p, dtype=torch.float32,
                                    device=keys.device), 0)
    r = cum[-1] * (1.0 - uniform(keys))
    ind = torch.searchsorted(cum, r.reshape(-1)).reshape(r.shape)
    return a.to(keys.device)[ind]
