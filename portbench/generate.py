"""Inputs and weights from ``--seed``, made on the device.

Every stream (the weights, a rank's token rows, a rank's ring batch)
draws from a generator seeded with ``stream_seed(seed, *stream)``, so the
program and the reference are handed the same tensors and a seed of any
size (negative ones too) gives one fixed set of inputs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

WEIGHTS, TOKENS, IMAGES = 0, 1, 2


def stream_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for the stream ``stream`` of run seed ``seed``."""
    state = np.random.SeedSequence([seed % 2 ** 64, *stream]).generate_state(
        1, np.uint64)[0]
    return int(state) >> 1


def generator(device: torch.device, seed: int, *stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *stream))


def make_params(specs: List[Tuple[str, tuple, str, float]], seed: int,
                device: torch.device) -> Dict[str, torch.Tensor]:
    """fp32 weights for ``specs`` (``(name, shape, kind, value)``): every
    ``normal`` leaf a scaled slice of one ``randn`` call, every ``const``
    leaf filled."""
    total = sum(math.prod(s) for _, s, kind, _ in specs if kind == "normal")
    flat = torch.randn(total, generator=generator(device, seed, WEIGHTS),
                       device=device)
    out, offset = {}, 0
    for name, shape, kind, value in specs:
        n = math.prod(shape)
        if kind == "normal":
            out[name] = flat[offset:offset + n].view(shape).mul_(value)
            offset += n
        else:
            out[name] = torch.full(shape, float(value), device=device)
    return out
