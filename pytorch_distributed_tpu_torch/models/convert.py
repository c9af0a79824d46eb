"""Weight conversion from the JAX package's flax GPT-2 to the port's GPT2.

Layout facts: a flax ``Dense`` kernel is ``[in, out]`` and a torch
``Linear`` weight ``[out, in]``; a flax ``LayerNorm`` has ``scale``/``bias``
where torch has ``weight``/``bias``; the embedding tables copy as they are.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

__all__ = ["gpt2_state_dict_from_flax"]


def _t(a: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _dense(tree) -> Dict[str, torch.Tensor]:
    return {"weight": _t(tree["kernel"]).t().contiguous(),
            "bias": _t(tree["bias"])}


def _norm(tree) -> Dict[str, torch.Tensor]:
    return {"weight": _t(tree["scale"]), "bias": _t(tree["bias"])}


def gpt2_state_dict_from_flax(params) -> Dict[str, torch.Tensor]:
    """The flax param tree (``variables["params"]``, numpy or jax leaves,
    paths ``h_<i>/attn/c_attn/kernel`` ...) as a ``GPT2.load_state_dict``
    dict."""
    sd = {"wte": _t(params["wte"]), "wpe": _t(params["wpe"])}
    groups = {"ln_f": _norm(params["ln_f"])}
    n_layer = sum(1 for k in params if k.startswith("h_"))
    for i in range(n_layer):
        blk = params[f"h_{i}"]
        groups.update({
            f"h.{i}.ln_1": _norm(blk["ln_1"]),
            f"h.{i}.ln_2": _norm(blk["ln_2"]),
            f"h.{i}.attn.c_attn": _dense(blk["attn"]["c_attn"]),
            f"h.{i}.attn.c_proj": _dense(blk["attn"]["c_proj"]),
            f"h.{i}.mlp.c_fc": _dense(blk["mlp"]["c_fc"]),
            f"h.{i}.mlp.c_proj": _dense(blk["mlp"]["c_proj"]),
        })
    for prefix, tensors in groups.items():
        for name, t in tensors.items():
            sd[f"{prefix}.{name}"] = t
    return sd
