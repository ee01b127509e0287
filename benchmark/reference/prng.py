"""Frozen copy of the port's ``crafter_tpu_torch/prng.py`` for the
benchmark's reference: every call of a CUDA kernel replaced by its
plain twin, nothing imported from the port.  The port's own text
follows.

Bit-exact threefry-2x32 in PyTorch for the draws the main path makes.

The JAX package draws its worlds and episode keys through ``jax.random``
with the default threefry2x32 implementation and
``jax_threefry_partitionable=True`` (the default of the installed JAX).
This module reproduces those bits, batched over a leading key axis and on
whatever device the keys live on:

* ``key(seed)``          -> words (0, seed)              (prng.threefry_seed)
* ``fold_in(k, d)``      -> threefry(k, (0, d))           (prng.threefry_fold_in)
* ``split(k, n)[i]``     -> threefry(k, (0, i))           (foldlike split)
* ``random_bits(k, s)``  -> b0 ^ b1 of threefry(k, (0, i)) over flat index i
* ``uniform`` / ``randint`` / ``permutation`` / ``categorical`` as
  ``jax.random`` builds them from those bits.

``random_bits``, ``uniform``, ``randint`` and ``categorical`` also draw a
shard of a larger draw: with ``rows=(start, total)`` the result is rows
``[start, start + shape[axis])`` of the draw of the global shape whose
``axis`` is ``total`` long, bit for bit.  That is what a sharded draw gives
each shard under ``jax_threefry_partitionable=True``: the counters are flat
indices into the global shape.

A key is an int64 tensor ``(..., 2)`` holding the two uint32 words; int64
keeps every intermediate exact without unsigned tensor support, and all
arithmetic is masked back to 32 bits.
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
  return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
  """The Threefry-2x32 block (20 rounds) on int64 words in [0, 2**32)."""
  ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
  x0 = (x0 + ks[0]) & MASK32
  x1 = (x1 + ks[1]) & MASK32
  for i in range(5):
    for r in _ROT[i % 2]:
      x0 = (x0 + x1) & MASK32
      x1 = _rotl(x1, r) ^ x0
    x0 = (x0 + ks[(i + 1) % 3]) & MASK32
    x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
  return x0, x1


def key(seed: int, device='cuda') -> torch.Tensor:
  """``jax.random.key(seed)`` for a non-negative 32-bit seed: (2,) words."""
  return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                      device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
  """``jax.random.fold_in`` over a batch: keys (..., 2), data broadcastable
  to ``keys.shape[:-1]`` (taken as uint32)."""
  data = torch.as_tensor(data, device=keys.device).to(torch.int64) & MASK32
  b0, b1 = threefry2x32(keys[..., 0], keys[..., 1],
                        torch.zeros_like(data), data)
  return torch.stack([b0, b1], -1)


def split(keys: torch.Tensor, num: int) -> torch.Tensor:
  """``jax.random.split(k, num)`` per key: (..., 2) -> (..., num, 2)."""
  i = torch.arange(num, dtype=torch.int64, device=keys.device)
  b0, b1 = threefry2x32(keys[..., None, 0], keys[..., None, 1],
                        torch.zeros_like(i), i)
  return torch.stack([b0, b1], -1)


def _counters(shape, rows, axis, device) -> torch.Tensor:
  """The flat threefry counters of a draw of ``shape``: ``0..size-1``, or
  with ``rows=(start, total)`` the global flat indices of rows
  ``[start, start + shape[axis])`` of a draw whose ``axis`` is ``total``
  long."""
  shape = tuple(int(s) for s in shape)
  if rows is None:
    return torch.arange(math.prod(shape), dtype=torch.int64, device=device)
  start, total = (int(v) for v in rows)
  if not 0 <= start <= total - shape[axis]:
    raise ValueError(f'rows {rows} do not hold {shape[axis]} rows')
  inner = math.prod(shape[axis + 1:])
  ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
  return (ar(math.prod(shape[:axis]))[:, None, None] * (total * inner)
          + (ar(shape[axis]) + start)[None, :, None] * inner
          + ar(inner)[None, None, :]).reshape(-1)


def random_bits(keys: torch.Tensor, shape, rows=None,
                axis: int = 0) -> torch.Tensor:
  """32 random bits per element, (..., *shape) int64, as
  ``jax.random.bits(k, shape, uint32)``; ``rows=(start, total)`` draws
  rows ``[start, start + shape[axis])`` of a draw whose ``axis`` is
  ``total`` long."""
  i = _counters(shape, rows, axis, keys.device)
  b0, b1 = threefry2x32(keys[..., None, 0], keys[..., None, 1],
                        torch.zeros_like(i), i)
  return (b0 ^ b1).reshape(keys.shape[:-1] + tuple(shape))


def uniform(keys: torch.Tensor, shape, rows=None,
            axis: int = 0) -> torch.Tensor:
  """``jax.random.uniform(k, shape)`` (float32 in [0, 1)) per key; ``rows``
  and ``axis`` as for :func:`random_bits`."""
  # 23 random mantissa bits under the exponent of 1.0, minus 1.0
  # (random.py:_uniform); the word stays below 2**31, so int32 holds it.
  bits = (random_bits(keys, shape, rows, axis) >> 9) | 0x3F800000
  return bits.to(torch.int32).view(torch.float32) - 1.0


def randint(keys: torch.Tensor, minval: int, maxval: int,
            shape=(), rows=None, axis: int = 0) -> torch.Tensor:
  """``jax.random.randint(k, shape, minval, maxval)`` (int32) per key:
  (..., *shape); ``rows`` and ``axis`` as for :func:`random_bits`.

  JAX splits the key in two, draws 32 bits from each and combines them
  modulo the span with uint32 wrapping (random.py:_randint)."""
  sub = split(keys, 2)
  hi = random_bits(sub[..., 0, :], shape, rows, axis)
  lo = random_bits(sub[..., 1, :], shape, rows, axis)
  span = (maxval - minval) & MASK32
  mult = (2 ** 16) % span
  mult = ((mult * mult) & MASK32) % span
  off = (((hi % span) * mult) & MASK32) + (lo % span)
  off = (off & MASK32) % span
  return (minval + off).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
  """``jax.random.permutation(key, n)`` for one (2,) key: (n,) int64.

  JAX shuffles by sorting (random.py:_shuffle): ``ceil(3 ln n / ln(2**32 -
  1))`` rounds, each splitting the key in two, drawing 32 bits per element
  from the second half and sorting the values stably by those bits."""
  n = int(n)
  x = torch.arange(n, dtype=torch.int64, device=key.device)
  rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK32)))
  for _ in range(rounds):
    key, sub = split(key, 2)
    order = torch.sort(random_bits(sub, (n,)), stable=True).indices
    x = x[order]
  return x


def categorical(key: torch.Tensor, logits: torch.Tensor,
                rows=None) -> torch.Tensor:
  """``jax.random.categorical(key, logits)`` over the last axis for one key:
  the argmax of the logits plus Gumbel noise ``-log(-log(u))``.  With
  ``rows=(start, total)`` the logits are rows ``[start, start + n)`` of a
  ``(total, A)`` batch, and the noise is theirs in the global draw.

  The uniform draw ``u`` is JAX's bit for bit (its ``uniform(minval=tiny)``
  only lifts an exact 0 to the smallest normal float); the two logarithms
  are this library's, so the result equals JAX's draw except where two
  perturbed logits lie within the logarithms' rounding of each other."""
  u = uniform(key, tuple(logits.shape), rows).clamp_min(
      torch.finfo(torch.float32).tiny)
  gumbel = -torch.log(-torch.log(u))
  return torch.argmax(gumbel.to(logits.dtype) + logits, dim=-1)
