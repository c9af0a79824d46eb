"""``hand-rolled-reshard``: resharding sequences outside ``redistribute/``.

Port of ``pytorch_distributed_tpu/analysis/rules/reshard.py``. The port
has one sanctioned path from one layout to another: the redistribution
planner and executor (``pytorch_distributed_tpu_torch.redistribute``),
which plans each transfer as the fewest pieces through a bounded staging
buffer. A hand-rolled reshard, an ``all_gather`` whose result is then
cut back down, pays the exact full-replica peak (the source block plus the
whole tensor on every rank) that the planner exists to avoid, and splits
reshard logic back across call sites.

Two patterns fire:

* an ``all_gather`` / ``all_gather_into_tensor`` result flowing into
  ``narrow``, ``chunk``, ``split``, ``tensor_split`` or a slice
  (``g[:, lo:hi]``) within the same function: the gather-then-slice
  decomposition itself. The result is the assigned name, or the output
  buffer a ``dist.*``/``comm.*`` gather writes (its first argument);
* a manual per-parameter gather/scatter loop: a loop (or comprehension)
  over ``parameters()``-family output whose body both gathers the loop
  variable AND scatters or slices (``reduce_scatter``,
  ``reduce_scatter_tensor``, ``scatter``, or the slicing ops above): the
  FlatParameter unshard/reshard bookkeeping written by hand. FSDP's
  ``parallel.fsdp`` holds this per parameter, inside the model's read of
  the weight and autograd's backward, where no loop over parameters runs.

The reference's third pattern, a ``jax.device_put`` onto a mesh sharding,
has no counterpart: the port places a tensor on its rank's card and cuts
it with the planner. Files under ``reshard_allowed_paths`` (default: the
``redistribute`` package) are exempt.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set

from pytorch_distributed_tpu_torch.analysis import astutil
from pytorch_distributed_tpu_torch.analysis.core import (
    Finding, Module, Rule, register,
)
from pytorch_distributed_tpu_torch.analysis.rules.coalesce import (
    _param_names,
    iterates_params,
    target_names,
)
from pytorch_distributed_tpu_torch.analysis.rules.host_sync import (
    collective_verb,
)

#: default file prefixes where hand-issued transfer steps ARE the planner
_DEFAULT_ALLOWED = ("pytorch_distributed_tpu_torch/redistribute",)

_GATHERS = {"all_gather", "all_gather_into_tensor"}
_SLICE_NAMES = {"narrow", "chunk", "split", "tensor_split"}
#: the scatter half of a hand-rolled unshard/reshard pair (pattern 2)
_SCATTER_NAMES = _SLICE_NAMES | {
    "reduce_scatter", "reduce_scatter_tensor", "scatter",
}


def _tail(module: Module, call: ast.Call) -> str:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    return (module.resolve(call.func) or "").split(".")[-1]


def _has_slice(sub: ast.Subscript) -> bool:
    idx = sub.slice
    elts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
    return any(isinstance(e, ast.Slice) for e in elts)


def _gather_names(module: Module, fn: ast.AST) -> Set[str]:
    """Names that hold an all_gather result inside ``fn``: assigned from
    one, or the output buffer (first argument) of a ``dist``/``comm``
    gather."""
    names: Set[str] = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
                and _tail(module, node.value) in _GATHERS):
            names.add(node.targets[0].id)
        elif (isinstance(node, ast.Call)
              and collective_verb(module, node) in _GATHERS
              and node.args and isinstance(node.args[0], ast.Name)):
            names.add(node.args[0].id)
    return names


def _slices_of(module: Module, nodes, names: Set[str]) -> List[ast.AST]:
    """Slicing operations under ``nodes`` that read one of ``names``:
    ``g.narrow(...)`` (the receiver chain reads it), ``torch.chunk(g,
    ...)``, ``g[..., lo:hi]``."""
    out: List[ast.AST] = []
    for stmt in nodes:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Subscript) and _has_slice(node):
                if astutil.names_in([node.value]) & names:
                    out.append(node)
            elif (isinstance(node, ast.Call)
                  and _tail(module, node) in _SLICE_NAMES):
                read = astutil.call_args(node)
                if isinstance(node.func, ast.Attribute):
                    read = read + [node.func.value]
                if astutil.names_in(read) & names:
                    out.append(node)
    return out


def _taint_body(body, seed: Set[str]) -> Set[str]:
    """Loop vars plus names assigned (directly) from tainted expressions
    inside the loop body: two propagation passes catch ``full =
    gather(p)`` chains without a fixpoint walk."""
    tainted = set(seed)
    for _ in range(2):
        for stmt in body:
            for node in ast.walk(stmt):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1
                        and isinstance(node.targets[0], ast.Name)):
                    continue
                if astutil.names_in([node.value]) & tainted:
                    tainted.add(node.targets[0].id)
    return tainted


def _allowed(module: Module, config: dict) -> bool:
    allowed = tuple(
        config.get("reshard_allowed_paths") or _DEFAULT_ALLOWED
    )
    path = module.path.replace("\\", "/").lstrip("./")
    return any(
        path.startswith(a.rstrip("/") + "/") or path == a.rstrip("/")
        or f"/{a.rstrip('/')}/" in f"/{path}"
        for a in allowed
    )


def _loop_gathers_and_cuts(module: Module, body, tainted: Set[str]):
    gathers = [
        node for stmt in body for node in ast.walk(stmt)
        if isinstance(node, ast.Call) and _tail(module, node) in _GATHERS
        and astutil.names_in(astutil.call_args(node)) & tainted
    ]
    cuts = [
        node for stmt in body for node in ast.walk(stmt)
        if (isinstance(node, ast.Call)
            and _tail(module, node) in _SCATTER_NAMES)
        or (isinstance(node, ast.Subscript) and _has_slice(node))
    ]
    return gathers, cuts


@register
class HandRolledReshard(Rule):
    name = "hand-rolled-reshard"
    description = (
        "all_gather result cut back down (narrow/chunk/split/slice), or a "
        "per-parameter gather+scatter loop, outside redistribute/: route "
        "layout changes through the planner or FSDP's sharded parameters"
    )

    def check(self, module: Module) -> Iterator[Finding]:
        if _allowed(module, self.config):
            return

        # pattern 1: gather-then-slice inside one function
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            gathered = _gather_names(module, fn)
            if not gathered:
                continue
            for node in _slices_of(module, fn.body, gathered):
                yield module.finding(
                    self.name, node,
                    "all_gather result sliced back down: the gather-then-"
                    "slice reshard pays a full-replica memory peak; the "
                    "planner moves only the pieces each rank needs "
                    "(redistribute.plan_transfer)",
                )

        # pattern 2: manual per-param gather/scatter loop
        names = _param_names(module)
        msg = (
            "per-parameter gather/scatter loop: hand-rolled FlatParameter "
            "unshard/reshard bookkeeping; hold the parameters sharded "
            "(FullyShardedDataParallel, parallel/fsdp.py) or reshard them "
            "with the planner (redistribute)"
        )
        for node in ast.walk(module.tree):
            if isinstance(node, ast.For):
                if not iterates_params(module, node.iter, names):
                    continue
                tainted = _taint_body(node.body, target_names(node.target))
                gathers, cuts = _loop_gathers_and_cuts(module, node.body,
                                                       tainted)
                if gathers and cuts:
                    yield module.finding(self.name, gathers[0], msg)
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.GeneratorExp)):
                loop_vars: Set[str] = set()
                hit = False
                for gen in node.generators:
                    if iterates_params(module, gen.iter, names):
                        hit = True
                        loop_vars |= target_names(gen.target)
                if not hit:
                    continue
                gathers, cuts = _loop_gathers_and_cuts(module, [node.elt],
                                                       loop_vars)
                if gathers and cuts:
                    yield module.finding(self.name, gathers[0], msg)
