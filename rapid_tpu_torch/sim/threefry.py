"""JAX's counter-based random numbers, in plain PyTorch ops.

The JAX engine draws a round's random ingress loss from threefry-2x32
(Random123's 20-round function) through ``jax.random``: the state's key is
split every round, the probe half is folded with the shard index on a mesh,
and ``uniform`` turns it into a float32 block. This module is the plain
version of that arithmetic, for JAX's default ``jax_threefry_partitionable``
mode and 32-bit integers (``jax_enable_x64`` off), which is how the JAX
package runs. The CUDA kernel ``kernels.threefry_draw`` (``csrc/threefry.cu``)
computes the same words on the card; the CPU path and the tests use this one.

A key is an int64 tensor ``[2]`` holding JAX's two uint32 words. Every value
here lies in ``[0, 2**32)`` and is held in int64, because PyTorch lacks the
shifts and wrapping adds of uint32: each add is masked with ``_U32``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

_U32 = 0xFFFFFFFF
# the key schedule's parity constant, and the rotations of the even and odd
# groups of four rounds (jax/_src/prng.py, Random123's threefry2x32_20)
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds of the counter pair ``(x0, x1)`` under
    the key ``(k0, k1)``, elementwise; the key words are ints or tensors
    that broadcast against the counters."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _U32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _U32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _U32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & _U32
    return x0, x1


def key_words(seed: int) -> Tuple[int, int]:
    """The two words of ``jax.random.PRNGKey(seed)`` with 32-bit integers:
    JAX takes the seed as a 32-bit integer, whose bits above 32 (the high
    word) are 0, so the key is ``(0, seed mod 2**32)``."""
    return 0, seed & _U32


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int64 ``[2]`` tensor."""
    return torch.tensor(key_words(seed), dtype=torch.int64, device=device)


def split(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.split(key)``: threefry of the counters ``(0, 0)`` and
    ``(0, 1)``. Returns ``(new key, probe key)``."""
    b1, b2 = threefry2x32(key[0], key[1], torch.zeros(2, dtype=torch.int64, device=key.device),
                          torch.arange(2, dtype=torch.int64, device=key.device))
    return torch.stack([b1[0], b2[0]]), torch.stack([b1[1], b2[1]])


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: threefry of the counter ``(0,
    data)``; ``data`` an int or a 0-d int64 tensor in ``[0, 2**32)``."""
    zero = torch.zeros((), dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[0], key[1], zero, zero + data)
    return torch.stack([y0, y1])


def random_bits(key: torch.Tensor, shape: Sequence[int], offset: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32 words in int64): element ``i``
    of the flattened shape takes the counter ``offset + i`` split into its
    high and low words, and its word is the xor of threefry's two outputs.
    ``offset`` reaches counters past ``2**32`` without a shape that large;
    ``jax.random`` itself always starts at 0."""
    n = 1
    for d in shape:
        n *= d
    counter = torch.arange(offset, offset + n, dtype=torch.int64, device=key.device)
    b1, b2 = threefry2x32(key[0], key[1], counter >> 32, counter & _U32)
    return (b1 ^ b2).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int], offset: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32 on ``[0, 1)``: the top
    23 bits of each word as the mantissa of a float in ``[1, 2)``, less 1."""
    bits = random_bits(key, shape, offset)
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def draw_plain(
    key: torch.Tensor, rows: int, k: int, shards: Optional[Sequence[int]] = None,
    halt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``kernels.threefry_draw``: one round's key split
    and uniform draw. Returns ``(new key, draw)``. Without ``shards`` the
    draw is ``uniform(probe key, (rows, k))``, the single-device round's;
    with it, each shard ``s`` (a global shard index) draws its ``[rows, k]``
    block from ``fold_in(probe key, s)``, the blocks stacked in the order
    given, as the sharded round draws them. ``rows`` 0 splits the key and
    draws nothing. Where the 0-d bool ``halt`` holds True the new key is
    ``key`` as it came; the draw is the same either way."""
    new_key, probe = split(key)
    if halt is not None:
        new_key = torch.where(halt, key, new_key)
    if shards is None:
        return new_key, uniform(probe, (rows, k))
    return new_key, torch.cat([uniform(fold_in(probe, s), (rows, k)) for s in shards])
