"""Hash primitives shared by host (numpy) and device (torch) code paths.

The weighted hash partitioner first maps keys to one of ``H >> N`` virtual
*hosts* by uniform hashing, then maps hosts to partitions via a small
routing table.  The uniform hash is the murmur3 32-bit finalizer
(``fmix32``), bit-identical to ``repro.core.hashing``.

Each function takes a numpy array (host planning, ``uint32`` arithmetic) or
a torch tensor (device path).  torch has no ``>>`` or ``%`` for ``uint32``
on the CPU, so the torch path runs in ``int64`` holding values masked to 32
bits, and multiplies in 16-bit halves so no product leaves the int64 range.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DEFAULT_NUM_HOSTS",
    "GOLDEN",
    "KEY_SENTINEL",
    "fmix32",
    "hash_mod",
    "hash_to_host",
    "mul32",
    "seed_mix",
]

# Number of virtual hosts H: a power of two so the modulo is a mask.
DEFAULT_NUM_HOSTS = 4096

# int32 padding sentinel for fixed-width heavy-key tables and state tables
# (larger than any real key; keys are non-negative int32).
KEY_SENTINEL = np.int32(2**31 - 1)

GOLDEN = 0x9E3779B9
_M32 = 0xFFFFFFFF


def seed_mix(seed: int) -> int:
    """The 32-bit constant a partitioner seed XORs into every key."""
    return (int(seed) * GOLDEN) & _M32


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, computed in
    16-bit halves (each partial product stays below 2**48)."""
    hi = ((x >> 16) * c) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * c) & _M32


def _u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M32


def fmix32(x):
    """murmur3 32-bit finalizer — a full-avalanche integer mixer.

    numpy input: returns ``uint32``.  torch input: returns ``int64`` holding
    the same 32-bit values.
    """
    if isinstance(x, torch.Tensor):
        x = _u32(x)
        x = x ^ (x >> 16)
        x = mul32(x, 0x85EBCA6B)
        x = x ^ (x >> 13)
        x = mul32(x, 0xC2B2AE35)
        return x ^ (x >> 16)
    x = np.asarray(x).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def _mixed(keys, seed: int):
    if isinstance(keys, torch.Tensor):
        return fmix32(_u32(keys) ^ seed_mix(seed))
    return fmix32(np.asarray(keys).astype(np.uint32) ^ np.uint32(seed_mix(seed)))


def hash_to_host(keys, num_hosts: int, seed: int = 0):
    """Uniformly hash ``keys`` to ``[0, num_hosts)`` as int32 (a mask when
    ``num_hosts`` is a power of two, else a modulo)."""
    h = _mixed(keys, seed)
    pow2 = num_hosts & (num_hosts - 1) == 0
    if isinstance(h, torch.Tensor):
        h = h & (num_hosts - 1) if pow2 else h % num_hosts
        return h.to(torch.int32)
    h = h & np.uint32(num_hosts - 1) if pow2 else h % np.uint32(num_hosts)
    return h.astype(np.int32)


def hash_mod(keys, n: int, seed: int = 0):
    """Plain uniform-hash-partitioner assignment: ``fmix32(key) mod n``."""
    h = _mixed(keys, seed)
    if isinstance(h, torch.Tensor):
        return (h % n).to(torch.int32)
    return (h % np.uint32(n)).astype(np.int32)
