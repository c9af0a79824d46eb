"""GPT-2 (openai-community/gpt2's architecture), plain fp32 PyTorch.

Learned token and position tables, pre-LN blocks (LayerNorm, causal
softmax attention with a fused q/k/v projection, GELU(tanh) MLP), a final
LayerNorm and the LM head tied to the token table; next-token
cross-entropy averaged over every token. Weights are ``nn.Linear``-shaped
(``[out, in]``) and named as the port names them, so one dict of tensors
feeds both. No dropout (the benchmark trains with it off).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.common import Params, Precision


def param_specs(cfg: dict) -> List[Tuple[str, tuple, str, float]]:
    """``(name, shape, kind, value)``: ``normal`` (value the std) or
    ``const``. GPT-2's initialisation: normal(``initializer_range``) for
    the tables and projections, the residual projections scaled by
    ``1 / sqrt(2 n_layer)``, zero biases, unit LayerNorm scales."""
    V, P, C, L = (cfg["vocab_size"], cfg["n_positions"], cfg["n_embd"],
                  cfg["n_layer"])
    std = cfg["initializer_range"]
    resid = std / math.sqrt(2 * L)
    specs = [("wte", (V, C), "normal", std), ("wpe", (P, C), "normal", std)]
    for i in range(L):
        h = f"h.{i}."
        specs += [
            (h + "ln_1.weight", (C,), "const", 1.0),
            (h + "ln_1.bias", (C,), "const", 0.0),
            (h + "attn.c_attn.weight", (3 * C, C), "normal", std),
            (h + "attn.c_attn.bias", (3 * C,), "const", 0.0),
            (h + "attn.c_proj.weight", (C, C), "normal", resid),
            (h + "attn.c_proj.bias", (C,), "const", 0.0),
            (h + "ln_2.weight", (C,), "const", 1.0),
            (h + "ln_2.bias", (C,), "const", 0.0),
            (h + "mlp.c_fc.weight", (4 * C, C), "normal", std),
            (h + "mlp.c_fc.bias", (4 * C,), "const", 0.0),
            (h + "mlp.c_proj.weight", (C, 4 * C), "normal", resid),
            (h + "mlp.c_proj.bias", (C,), "const", 0.0),
        ]
    specs += [("ln_f.weight", (C,), "const", 1.0),
              ("ln_f.bias", (C,), "const", 0.0)]
    return specs


def views(tensors: Params) -> Params:
    """The leaves as compared: each fused q/k/v projection (weight and
    bias) split into its three parts (``name[q]``, ``name[k]``,
    ``name[v]``), since the key bias alone has a gradient that is nought
    to rounding (softmax is blind to it)."""
    out = {}
    for n, t in tensors.items():
        if ".c_attn." in n:
            for part, piece in zip("qkv", t.chunk(3, dim=0)):
                out[f"{n}[{part}]"] = piece
        else:
            out[n] = t
    return out


def _block(x, p: Params, h: str, cfg: dict, prec: Precision):
    B, T, C = x.shape
    H = cfg["n_head"]
    D = C // H
    eps = cfg["layer_norm_epsilon"]
    a = F.layer_norm(x, (C,), p[h + "ln_1.weight"], p[h + "ln_1.bias"], eps)
    qkv = prec.linear(a, p[h + "attn.c_attn.weight"], p[h + "attn.c_attn.bias"])
    q, k, v = (t.reshape(B, T, H, D).transpose(1, 2) for t in qkv.split(C, -1))
    scores = prec.matmul(q, k.transpose(-1, -2)) / math.sqrt(D)
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    y = prec.matmul(probs, v).transpose(1, 2).reshape(B, T, C)
    x = x + prec.linear(y, p[h + "attn.c_proj.weight"], p[h + "attn.c_proj.bias"])
    a = F.layer_norm(x, (C,), p[h + "ln_2.weight"], p[h + "ln_2.bias"], eps)
    a = F.gelu(prec.linear(a, p[h + "mlp.c_fc.weight"], p[h + "mlp.c_fc.bias"]),
               approximate="tanh")
    return x + prec.linear(a, p[h + "mlp.c_proj.weight"], p[h + "mlp.c_proj.bias"])


def loss_sum(p: Params, tokens, targets, cfg: dict,
             prec: Precision) -> torch.Tensor:
    """The summed next-token cross-entropy of ``tokens [B, T]`` against
    ``targets [B, T]``."""
    T = tokens.shape[1]
    x = p["wte"][tokens] + p["wpe"][:T]
    for i in range(cfg["n_layer"]):
        x = _block(x, p, f"h.{i}.", cfg, prec)
    x = F.layer_norm(x, (x.shape[-1],), p["ln_f.weight"], p["ln_f.bias"],
                     cfg["layer_norm_epsilon"])
    logits = prec.matmul(x, p["wte"].t())
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1), reduction="sum")


#: rows the reference takes at a time (its fp32 logits of 4 x 1024 tokens
#: over GPT-2's vocabulary are 0.8 GB, and their gradient as much again)
BLOCK_ROWS = 4


def loss_and_grads(cfg: dict, prec: Precision, block_rows: int = BLOCK_ROWS):
    """``f(params, (tokens, targets)) -> (mean loss, grads)``, the rows
    taken ``block_rows`` at a time (every row is independent, so the
    gradient is the sum of the blocks')."""

    def f(params: Params, batch) -> Tuple[torch.Tensor, Dict]:
        tokens, targets = (t.long() for t in batch)
        leaves = {n: t.detach().requires_grad_() for n, t in params.items()}
        total = tokens.numel()
        acc = torch.zeros((), dtype=torch.float64, device=tokens.device)
        for r in range(0, tokens.shape[0], block_rows):
            part = loss_sum(leaves, tokens[r:r + block_rows],
                            targets[r:r + block_rows], cfg, prec)
            (part / total).backward()
            acc += part.detach().double()
        return acc / total, {n: t.grad for n, t in leaves.items()}

    return f
