"""Small sizes of the benchmark's cells, for runs on the CPU."""

from __future__ import annotations

import torch

from portbench import run as R

TINY_CFG = {
    "lm_train": dict(vocab_size=256, n_positions=32, n_embd=64, n_layer=2,
                     n_head=4),
    "cnn_train": dict(width=8, num_classes=10, image_size=64),
}
TINY_CELL = {
    "lm_train": dict(batch=4, seq_len=32, distinct_batches=4,
                     traced_steps=2),
    "cnn_train": dict(batch=8, ring=3, traced_steps=2),
}


def tiny_run(name: str, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
             trace: bool = False, device=None, rank: int = 0,
             world: int = 1, store=None) -> R.Run:
    """The cell ``name`` at a small size on the CPU."""
    mf, wl, cell, cfg = R.load_cell(name)
    cfg.update(TINY_CFG[cell["driver"]])
    cell.update(TINY_CELL[cell["driver"]])
    return R.Run(mf, wl, cell, cfg, seed, seconds, trace,
                 device or torch.device("cpu"), rank, world, store)
