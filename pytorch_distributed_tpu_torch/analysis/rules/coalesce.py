"""``uncoalesced-collective``: one eager collective per parameter.

Port of ``pytorch_distributed_tpu/analysis/rules/coalesce.py``. A loop
over ``model.parameters()`` (or ``named_parameters()``, ``buffers()``,
``named_buffers()``, ``state_dict()`` items) that issues a collective per
tensor (``dist.all_reduce(p.grad)``, ``comm.broadcast(p, group)``, ...)
pays one NCCL launch, its latency and its small-message bandwidth *per
parameter tensor*. A GPT-2 has 148 of them; the coalesced form (flatten
once into one buffer, one collective, split back: what
``strategies.broadcast_tensors`` and ``_Replicas.reduce_grads`` do, and
DDP's buckets) is an order of magnitude cheaper.

The rule fires only when the loop demonstrably iterates parameters (a
direct ``parameters()``-family iterator, or a name assigned from one in the
same file) AND the per-iteration collective consumes the loop variable: a
loop that merely logs shapes, or a collective on something else inside
the loop, stays quiet. So does a collective issued inside a ``with
coalescing_manager(group) as cm:`` block (the port's
``distributed.batch_ops`` one, or torch's ``_coalescing_manager``): the
manager batches the block's calls into one per dtype, which is the
coalesced form.
"""

from __future__ import annotations

import ast
from typing import Iterator, Set

from pytorch_distributed_tpu_torch.analysis.core import (
    Finding, Module, Rule, register,
)

#: eager collective verbs (point-to-point send/recv excluded: per-tensor
#: pipelining can be intentional)
EAGER_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "broadcast", "reduce", "gather", "scatter",
    "all_to_all", "all_to_all_single",
}

#: methods whose call output is the model's tensors
_PARAM_METHODS = {"parameters", "named_parameters", "buffers",
                  "named_buffers"}
#: wrappers that keep a tensor sequence a tensor sequence
_WRAPPERS = {"list", "tuple", "sorted", "enumerate", "zip", "reversed"}


def _is_params_expr(module: Module, node: ast.AST) -> bool:
    """Does this expression evaluate to the model's parameters (or
    buffers, or ``state_dict()`` items/values)?"""
    if not isinstance(node, ast.Call) or not isinstance(node.func,
                                                        ast.Attribute):
        return False
    attr = node.func.attr
    if attr in _PARAM_METHODS:
        return True
    if attr in ("items", "values"):
        inner = node.func.value
        return (isinstance(inner, ast.Call)
                and isinstance(inner.func, ast.Attribute)
                and inner.func.attr == "state_dict")
    return False


def _param_names(module: Module) -> Set[str]:
    """Names assigned from a parameters expression anywhere in the file:
    ``params = list(model.parameters())``."""
    names: Set[str] = set()
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        tgt = node.targets[0]
        if isinstance(tgt, ast.Name) and iterates_params(module, node.value,
                                                         set()):
            names.add(tgt.id)
    return names


def target_names(target: ast.AST) -> Set[str]:
    """Loop-variable names, including ``for name, p in ...`` tuples."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, (ast.Tuple, ast.List)):
        out: Set[str] = set()
        for el in target.elts:
            out |= target_names(el)
        return out
    return set()


def iterates_params(module: Module, it: ast.AST, names: Set[str]) -> bool:
    if _is_params_expr(module, it):
        return True
    if isinstance(it, ast.Name) and it.id in names:
        return True
    # list(...) / enumerate(...) / zip(...) keep parameter iteration
    if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
            and it.func.id in _WRAPPERS:
        return any(iterates_params(module, a, names) for a in it.args)
    return False


def _coalesced(module: Module, node: ast.AST) -> bool:
    """Whether ``node`` sits inside a ``with ...coalescing_manager(...)``
    block."""
    cur = module.parents.get(node)
    while cur is not None:
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                ctx = item.context_expr
                if isinstance(ctx, ast.Call) and (
                        module.dotted(ctx.func) or "").split(".")[-1] in (
                        "coalescing_manager", "_coalescing_manager"):
                    return True
        cur = module.parents.get(cur)
    return False


def _collective_calls(module: Module, body_nodes, loop_vars: Set[str]):
    """Eager collective calls in the loop body that consume a loop var,
    outside a coalescing manager."""
    for stmt in body_nodes:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call) or _coalesced(module, node):
                continue
            if isinstance(node.func, ast.Attribute):
                verb = node.func.attr
            elif isinstance(node.func, ast.Name):
                verb = node.func.id
            else:
                continue
            if verb not in EAGER_COLLECTIVES:
                continue
            arg_names = {
                n.id
                for a in list(node.args) + [kw.value for kw in node.keywords]
                for n in ast.walk(a) if isinstance(n, ast.Name)
            }
            if arg_names & loop_vars:
                yield node, verb


@register
class UncoalescedCollective(Rule):
    name = "uncoalesced-collective"
    description = (
        "loop over parameters()/buffers()/state_dict() issuing one eager "
        "collective per tensor: one NCCL launch per tensor; coalesce into "
        "one flat buffer and one call"
    )

    def check(self, module: Module) -> Iterator[Finding]:
        names = _param_names(module)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.For):
                if not iterates_params(module, node.iter, names):
                    continue
                loop_vars = target_names(node.target)
                for call, verb in _collective_calls(module, node.body,
                                                     loop_vars):
                    yield module.finding(
                        self.name, call,
                        f"eager {verb}() issued per parameter tensor in "
                        f"this loop: each call is a separate collective "
                        f"launch; flatten the tensors into one buffer, "
                        f"issue one collective and split it back",
                    )
            elif isinstance(node, (ast.ListComp, ast.SetComp,
                                   ast.GeneratorExp, ast.DictComp)):
                loop_vars: Set[str] = set()
                hit = False
                for gen in node.generators:
                    if iterates_params(module, gen.iter, names):
                        hit = True
                        loop_vars |= target_names(gen.target)
                if not hit:
                    continue
                elts = ([node.key, node.value]
                        if isinstance(node, ast.DictComp) else [node.elt])
                for call, verb in _collective_calls(module, elts, loop_vars):
                    yield module.finding(
                        self.name, call,
                        f"eager {verb}() mapped over parameter tensors in "
                        f"this comprehension: one collective launch per "
                        f"tensor; coalesce them into one buffer and issue "
                        f"one collective",
                    )
