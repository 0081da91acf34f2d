"""Independent random streams of one run, each from ``--seed`` and a tag."""

from __future__ import annotations

import zlib

import numpy as np
import torch


def seed_words(seed: int, tag: str) -> list[int]:
    """The words a stream's seed is built from: ``seed`` (any size) and the tag."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be >= 0, got {seed}")
    words = []
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            break
    return words + [zlib.crc32(tag.encode())]


def rng(seed: int, tag: str) -> np.random.Generator:
    """A numpy generator of the stream ``tag``."""
    return np.random.default_rng(seed_words(seed, tag))


def generator(seed: int, tag: str, device) -> torch.Generator:
    """A torch generator of the stream ``tag`` on ``device``."""
    state = np.random.SeedSequence(seed_words(seed, tag)).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state) >> 1)
    return gen
