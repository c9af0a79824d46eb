"""GPT-2 training through the port's ``Trainer``.

The model is ``models.GPT2`` at the configuration's widths, the compute
dtype the configuration's (bf16 on the card: the ``bf16`` policy, fp32
parameters), attention through ``ops.flash_attention`` (the causal CUDA
kernels B1-B3 on the card) and the tied LM head at its default (fp32
inputs). The feed is ``examples/train_gpt2.py``'s: a map-style dataset of
token rows read in order by ``data.make_loader`` (pinned host memory) and
copied ahead by ``data.prefetch_to_device``. The rows (``seq_len + 1``
tokens, uniform over the vocabulary) are drawn from the seed, and the
stream cycles over them epoch after epoch.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from portbench import generate, program
from portbench.reference import common, gpt2 as ref

WORK = "tokens"
specs = ref.param_specs
views = ref.views


def work_per_step(cell: dict) -> int:
    return cell["batch"] * cell["seq_len"]


class TokenRows(torch.utils.data.Dataset):
    def __init__(self, rows: np.ndarray):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        row = self.rows[i]
        return row[:-1], row[1:]


def token_rows(cfg: dict, cell: dict, seed: int, rank: int) -> np.ndarray:
    rng = np.random.default_rng(generate.stream_seed(seed, generate.TOKENS, rank))
    return rng.integers(0, cfg["vocab_size"],
                        size=(cell["distinct_batches"] * cell["batch"],
                              cell["seq_len"] + 1), dtype=np.int32)


def build(cfg: dict, cell: dict, seed: int, device: torch.device,
          world: int, rank: int):
    """``(trainer, feed)``: the port's trainer holding the benchmark's
    weights, and the endless stream of batches the runner is fed."""
    from pytorch_distributed_tpu_torch.data import make_loader, prefetch_to_device
    from pytorch_distributed_tpu_torch.models import GPT2, GPT2Config
    from pytorch_distributed_tpu_torch.ops.flash_attention import flash_attention
    from pytorch_distributed_tpu_torch.trainer import Trainer, lm_loss

    on_card = device.type == "cuda"
    model = GPT2(GPT2Config(
        vocab_size=cfg["vocab_size"], n_positions=cfg["n_positions"],
        n_embd=cfg["n_embd"], n_layer=cfg["n_layer"], n_head=cfg["n_head"],
        layer_norm_eps=cfg["layer_norm_epsilon"],
        dtype=getattr(torch, cfg["compute_dtype"]) if on_card else torch.float32,
        attn_impl=flash_attention), device=device)
    program.load_params(model, generate.make_params(specs(cfg), seed, device))
    trainer = Trainer(model, program.optimizer(model, cfg["optimizer"]),
                      program.strategy(device, world), loss_fn=lm_loss,
                      policy=cfg["policy"] if on_card else "fp32")
    loader = make_loader(TokenRows(token_rows(cfg, cell, seed, rank)),
                         cell["batch"], None, device=device)
    endless = itertools.chain.from_iterable(itertools.repeat(loader))
    feed = (program.local_batch(b, world)
            for b in prefetch_to_device(endless, device, cell["prefetch"]))
    return trainer, feed


def reference_batches(cfg: dict, cell: dict, seed: int, device: torch.device,
                      rank: int, n: int):
    rows = torch.from_numpy(token_rows(cfg, cell, seed, rank)[:n * cell["batch"]])
    rows = rows.to(device).long()
    return [(r[:, :-1], r[:, 1:]) for r in rows.split(cell["batch"])]


def reference(cfg: dict, cell: dict, params0, batches, precision: str = "fp32",
              keep=None, group=None) -> dict:
    """The plain reference's reading over ``batches`` from ``params0``."""
    with common.exact_fp32():
        f = ref.loss_and_grads(cfg, common.Precision(precision))
        return common.train(f, params0, batches,
                            common.optimizer(cfg["optimizer"]), views, keep)
