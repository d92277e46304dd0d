"""Independent streams from one --seed: weights, images, labels, the
sample of outputs that are compared."""

from __future__ import annotations

import zlib

import numpy as np


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for `purpose`, fixed by `seed`; any whole number."""
    entropy = [seed % 2**64, zlib.crc32(purpose.encode())]
    hi, lo = np.random.SeedSequence(entropy).generate_state(2, dtype=np.uint32)
    return (int(hi) << 31) ^ int(lo)


def rng(seed: int, purpose: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, purpose))
