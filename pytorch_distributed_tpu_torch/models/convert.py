"""State conversion between the JAX package's flax models and the port's.

Layout facts: a flax ``Dense`` kernel is ``[in, out]`` and a torch
``Linear`` weight ``[out, in]``; a flax ``LayerNorm`` has ``scale``/``bias``
where torch has ``weight``/``bias``; the embedding tables copy as they are.

Both directions are here: flax params -> ``GPT2.load_state_dict`` dict, the
port's state dict -> a flax tree of numpy arrays (to compare trained
parameters), and optax ``adamw`` state (``ScaleByAdamState`` count/mu/nu)
-> ``torch.optim.AdamW`` state (``step``, ``exp_avg``, ``exp_avg_sq``).

ResNet: the port's module names are the flax tree's paths (``conv_init``,
``stage0_block1.Conv_0``, ...), so the mapping is leaf by leaf: a conv
``kernel`` (HWIO) is a torch ``weight`` (OIHW), the ``fc`` kernel
``[in, out]`` a ``weight`` ``[out, in]``, a BatchNorm's ``scale`` its
``weight``, and its ``batch_stats`` ``mean``/``var`` the buffers
``running_mean``/``running_var``. optax ``sgd`` momentum (``TraceState``
``trace``, a tree like the params) is torch SGD's ``momentum_buffer``.

Sharded training (``parallel.sharded_update``): the optax loaders take the
trainer's ``layout`` and give each rank its block of every sharded state
tensor (the optax state given whole, as numpy); :func:`full_state_dict`
and :func:`full_optimizer_state` gather the blocks back into whole tensors
on every rank (collective calls: every rank makes them).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

__all__ = [
    "full_optimizer_state",
    "full_state_dict",
    "gpt2_flax_from_state_dict",
    "gpt2_state_dict_from_flax",
    "load_adamw_state_from_optax",
    "load_sgd_state_from_optax",
    "resnet_flax_from_state_dict",
    "resnet_state_dict_from_flax",
]


def _t(a: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(a))


def _opt_tensors(optimizer, model, layout):
    """(name, the optimizer's tensor, its Shard or None) for every tensor
    in ``optimizer``'s groups."""
    if layout is None:   # an expert stack under EP: its ep block
        name_of = {id(p): (n, getattr(p, "ep", None))
                   for n, p in model.named_parameters()}
    else:
        name_of = {id(leaf.tensor): (leaf.name, layout.spec(leaf.name))
                   for leaf in layout.leaves}
    for group in optimizer.param_groups:
        for p in group["params"]:
            yield (*name_of[id(p)], p, group)


def _local(full: torch.Tensor, spec) -> torch.Tensor:
    from pytorch_distributed_tpu_torch.parallel.fsdp import local_block

    return full if spec is None else local_block(full, spec.dim, spec.rank,
                                                 spec.size)


def _whole(t: torch.Tensor, spec, p) -> torch.Tensor:
    """``t`` (a tensor shaped like the block ``p`` holds) whole: its FSDP
    shard gathered over ``spec``, then its tensor-parallel block over
    ``p.tp``."""
    from pytorch_distributed_tpu_torch.parallel.fsdp import full_tensor
    from pytorch_distributed_tpu_torch.parallel.tensor_parallel import (
        tp_full_tensor,
    )

    t = full_tensor(t, spec)
    return t if getattr(p, "tp", None) is None else tp_full_tensor(t, p.tp)


@torch.no_grad()
def full_state_dict(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every parameter that FSDP, tensor or
    expert parallelism holds as a block gathered back into the whole
    tensor (a copy; collective)."""
    params = dict(model.named_parameters())
    out = {}
    for name, t in model.state_dict().items():
        p = params.get(name)
        spec = getattr(p, "fsdp", None) or getattr(p, "ep", None)
        out[name] = _whole(t, spec, p)
    return out


@torch.no_grad()
def full_optimizer_state(optimizer: torch.optim.Optimizer,
                         model: torch.nn.Module, layout=None
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{parameter name: {state key: whole tensor}}`` of ``optimizer``,
    its sharded state gathered through the trainer's ``layout`` (None:
    held whole; collective)."""
    out = {}
    for name, spec, p, _ in _opt_tensors(optimizer, model, layout):
        out[name] = {k: (_whole(v, spec, p) if v.shape == p.shape and v.dim()
                         else v.detach().clone())
                     for k, v in optimizer.state[p].items()
                     if isinstance(v, torch.Tensor)}
    return out


def _pairs(n_layer: int, moe=frozenset()
           ) -> Iterator[Tuple[Tuple[str, ...], str, bool]]:
    """(flax path, torch name, transposed) for every GPT-2 parameter;
    ``moe`` holds the indices of the MoE blocks (a routed ``moe`` in place
    of the ``mlp``: the router a Dense, the expert stacks as they are)."""
    yield ("wte",), "wte", False
    yield ("wpe",), "wpe", False
    yield ("ln_f", "scale"), "ln_f.weight", False
    yield ("ln_f", "bias"), "ln_f.bias", False
    for i in range(n_layer):
        for ln in ("ln_1", "ln_2"):
            yield (f"h_{i}", ln, "scale"), f"h.{i}.{ln}.weight", False
            yield (f"h_{i}", ln, "bias"), f"h.{i}.{ln}.bias", False
        linears = (("attn", "c_attn"), ("attn", "c_proj"))
        linears += ((("moe", "router"),) if i in moe else
                    (("mlp", "c_fc"), ("mlp", "c_proj")))
        for mod, lin in linears:
            yield (f"h_{i}", mod, lin, "kernel"), f"h.{i}.{mod}.{lin}.weight", True
            yield (f"h_{i}", mod, lin, "bias"), f"h.{i}.{mod}.{lin}.bias", False
        if i in moe:
            for stack in ("experts_up", "experts_down"):
                yield (f"h_{i}", "moe", stack), f"h.{i}.moe.{stack}", False


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _n_layer_flax(params) -> int:
    return sum(1 for k in params if k.startswith("h_"))


def _moe_flax(params) -> frozenset:
    return frozenset(int(k[2:]) for k in params
                     if k.startswith("h_") and "moe" in params[k])


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _unstack_blocks(params) -> Dict[str, Any]:
    """A GPT2Pipe tree (``blocks``: the per-block trees stacked ``[L,
    ...]``) as the unsharded model's (``h_<i>``); any other tree as it
    is."""
    if "blocks" not in params:
        return params
    out = {k: v for k, v in params.items() if k != "blocks"}
    first = params["blocks"]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    for i in range(np.asarray(first).shape[0]):
        out[f"h_{i}"] = _map_tree(lambda a: np.asarray(a)[i],
                                  params["blocks"])
    return out


def gpt2_state_dict_from_flax(params, layers=None) -> Dict[str, torch.Tensor]:
    """The flax param tree (``variables["params"]``, numpy or jax leaves,
    paths ``h_<i>/attn/c_attn/kernel`` ...) as a ``GPT2.load_state_dict``
    dict. Also maps any tree of the same structure (optax's mu/nu), and
    the reference ``GPT2Pipe``'s tree, whose ``blocks`` stack the blocks'
    trees ``[L, ...]``. ``layers`` keeps the blocks of those indices only
    (a pipeline stage's ``GPT2Pipe.layers``)."""
    params = _unstack_blocks(params)
    keep = None if layers is None else {f"h.{i}." for i in layers}
    sd = {}
    for path, name, transposed in _pairs(_n_layer_flax(params),
                                         _moe_flax(params)):
        if (keep is not None and name.startswith("h.")
                and name[:name.index(".", 2) + 1] not in keep):
            continue
        t = _t(_get(params, path))
        sd[name] = t.t().contiguous() if transposed else t
    return sd


def gpt2_flax_from_state_dict(state_dict, *, stacked: bool = False
                              ) -> Dict[str, Any]:
    """The port's ``GPT2.state_dict()`` as a flax param tree of numpy
    arrays (the inverse of :func:`gpt2_state_dict_from_flax`); with
    ``stacked`` the reference ``GPT2Pipe``'s tree, the blocks stacked
    ``[L, ...]`` under ``blocks`` (every block's keys needed: the union of
    the stages' state dicts)."""
    n_layer = len({k.split(".")[1] for k in state_dict if k.startswith("h.")})
    moe = frozenset(int(k.split(".")[1]) for k in state_dict
                    if k.startswith("h.") and k.split(".")[2] == "moe")
    tree: Dict[str, Any] = {}
    for path, name, transposed in _pairs(n_layer, moe):
        a = state_dict[name].detach().cpu().float().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(a.T) if transposed else a
    if stacked:
        blocks = [tree.pop(f"h_{i}") for i in range(n_layer)]

        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return np.stack(xs)

        tree["blocks"] = stack(*blocks)
    return tree


def load_adamw_state_from_optax(optimizer: torch.optim.Optimizer,
                                model: torch.nn.Module, count, mu, nu,
                                layout=None) -> None:
    """Set ``optimizer``'s ``torch.optim.AdamW`` state for ``model``'s
    parameters from optax adamw state (``ScaleByAdamState``: ``count`` and
    the ``mu``/``nu`` trees, numpy). optax's first and second moments are
    torch's ``exp_avg`` and ``exp_avg_sq``, its ``count`` torch's ``step``.
    Tensors go to each parameter's device (``step`` to the CPU unless the
    group is ``capturable`` or ``fused``, as torch keeps it). Under a
    sharded trainer pass its ``layout``: each rank takes its blocks."""
    mu_sd = gpt2_state_dict_from_flax(mu)
    nu_sd = gpt2_state_dict_from_flax(nu)
    step = float(np.asarray(count))
    for name, spec, p, group in _opt_tensors(optimizer, model, layout):
        on_device = group.get("capturable") or group.get("fused")
        optimizer.state[p] = {
            "step": torch.tensor(step, dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": _local(mu_sd[name], spec).to(p.device, p.dtype),
            "exp_avg_sq": _local(nu_sd[name], spec).to(p.device, p.dtype),
        }


# -- ResNet ----------------------------------------------------------------
_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if hasattr(value, "items"):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _from_flax_kernel(a: np.ndarray) -> torch.Tensor:
    if a.ndim == 4:                       # conv HWIO -> OIHW
        return torch.tensor(np.ascontiguousarray(a.transpose(3, 2, 0, 1)))
    return torch.tensor(np.ascontiguousarray(a.T))    # Dense [in, out]


def resnet_state_dict_from_flax(params, batch_stats=None
                                ) -> Dict[str, torch.Tensor]:
    """The flax ResNet's ``params`` (and ``batch_stats``) trees, numpy or
    jax leaves, as a ``ResNet.load_state_dict`` dict. Without
    ``batch_stats`` only the parameters are mapped (also any tree shaped
    like them, such as optax's momentum ``trace``)."""
    sd = {}
    for path, leaf in _leaves(params):
        name = ".".join(path[:-1] + (_PARAM_LEAF[path[-1]],))
        a = np.asarray(leaf)
        sd[name] = _from_flax_kernel(a) if path[-1] == "kernel" else _t(a)
    for path, leaf in _leaves(batch_stats or {}):
        sd[".".join(path[:-1] + (_STAT_LEAF[path[-1]],))] = _t(leaf)
    return sd


def resnet_flax_from_state_dict(state_dict) -> Tuple[Dict, Dict]:
    """The port's ``ResNet.state_dict()`` as the flax ``(params,
    batch_stats)`` trees of numpy arrays (the inverse of
    :func:`resnet_state_dict_from_flax`)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        t = t.detach().cpu()
        if t.dtype not in (torch.float32, torch.float64):
            t = t.float()
        a = t.numpy().copy()        # no view of the tensor
        if leaf in ("running_mean", "running_var"):
            tree, key = stats, leaf.removeprefix("running_")
        elif leaf == "bias":
            tree, key = params, "bias"
        elif a.ndim == 1:
            tree, key = params, "scale"
        else:
            tree, key = params, "kernel"
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[key] = np.ascontiguousarray(a)
    return params, stats


def load_sgd_state_from_optax(optimizer: torch.optim.Optimizer,
                              model: torch.nn.Module, trace,
                              layout=None) -> None:
    """Set ``optimizer``'s ``torch.optim.SGD`` momentum buffers for a
    ResNet ``model`` from optax ``sgd`` state: the ``trace`` tree of
    ``TraceState`` (numpy or jax leaves). optax's ``trace = g + m * trace``
    is torch's ``buf = m * buf + g`` (dampening 0). Each buffer takes its
    parameter's device, dtype and memory format; under a sharded trainer
    (its ``layout``) each rank takes its blocks."""
    sd = resnet_state_dict_from_flax(trace)
    for name, spec, p, _ in _opt_tensors(optimizer, model, layout):
        buf = torch.empty_like(p)
        buf.copy_(_local(sd[name], spec))
        optimizer.state[p]["momentum_buffer"] = buf
