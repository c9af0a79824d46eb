"""Host-device synchronization rules.

Port of ``pytorch_distributed_tpu/analysis/rules/host_sync.py``.

``host-sync-in-hot-loop``: a ``.item()`` / ``.tolist()`` / ``.cpu()`` /
``.numpy()`` / ``float()`` / ``np.asarray()`` on a card value, or any
``torch.cuda.synchronize()`` / ``stream.synchronize()`` /
``event.synchronize()``, inside a train/decode step loop stalls the
launch queue: the host blocks until the card catches up, so it stops
queueing the next step's kernels (or graph replay) while the card runs
this one.

``comm-staging``: a fresh ``torch.tensor(...)`` /
``torch.as_tensor([...])`` / ``np.array(...)`` built inline as the
argument of a collective (``dist.*`` or the port's ``comm.*``) allocates
and copies a host buffer (and, for a card group, a host-to-card copy) on
every call; sizes and small headers should be staged once (python ints,
a prebuilt buffer).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set, Tuple

from pytorch_distributed_tpu_torch.analysis import astutil
from pytorch_distributed_tpu_torch.analysis.core import (
    Finding, Module, Rule, register,
)

#: function-name patterns treated as step/serve loops (config-extendable)
DEFAULT_HOT_PATTERNS = (
    r"(^|_)steps?($|_)",
    r"(^|_)loop($|_)",
    r"^run$",
    r"^decode",
    r"^generate",
    r"^serve",
    r"^train",
)

#: always-sync calls (flagged in hot regions whatever the receiver)
_ALWAYS_SYNC = {"torch.cuda.synchronize"}
_ALWAYS_SYNC_METHODS = {"synchronize"}
#: provenance-gated sync spellings
_GATED_CALLS = {"float", "int", "np.array", "np.asarray"}
_GATED_METHODS = {"item", "tolist", "cpu", "numpy"}

#: collectives of ``torch.distributed`` and of the port's ``comm``
COLLECTIVE_VERBS = {
    "all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
    "reduce_scatter_tensor", "broadcast", "all_to_all", "all_to_all_single",
    "gather", "scatter", "reduce", "send", "isend", "recv", "irecv", "p2p",
}
_STAGING_CALLS = {"torch.tensor", "np.array", "np.asarray"}


def collective_verb(module: Module, call: ast.Call) -> Optional[str]:
    """The verb of a ``dist.<verb>(...)`` or ``comm.<verb>(...)`` call (a
    module whose last name is ``comm``: ``parallel.comm``), else None."""
    qual = module.resolve(call.func) or ""
    mod, _, verb = qual.rpartition(".")
    if verb not in COLLECTIVE_VERBS:
        return None
    if mod == "dist" or mod.split(".")[-1] == "comm":
        return verb
    return None


def _hot_patterns(config: dict) -> List[re.Pattern]:
    pats = list(DEFAULT_HOT_PATTERNS)
    pats.extend(config.get("hot_function_patterns") or ())
    return [re.compile(p) for p in pats]


def _is_hot_name(name: str, patterns: List[re.Pattern]) -> bool:
    return any(p.search(name) for p in patterns)


class _HotRegions:
    """Loop bodies inside hot-named functions, plus local functions called
    directly from those loop bodies (whole body hot, one hop)."""

    def __init__(self, module: Module, patterns: List[re.Pattern]):
        self.module = module
        # (region root nodes, owning function, human label)
        self.regions: List[Tuple[List[ast.stmt], ast.AST, str]] = []
        defs_by_name: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs_by_name.setdefault(node.name, []).append(node)

        called_from_hot: Set[str] = set()
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if not _is_hot_name(node.name, patterns):
                continue
            label = module.symbol_for(node)
            for loop in astutil.walk_no_nested_funcs(node.body):
                if not isinstance(loop, (ast.For, ast.While)):
                    continue
                self.regions.append((list(loop.body), node, label))
                for sub in ast.walk(loop):
                    if isinstance(sub, ast.Call):
                        dotted = module.dotted(sub.func) or ""
                        called_from_hot.add(dotted.split(".")[-1])

        for name in called_from_hot:
            for fn in defs_by_name.get(name, ()):  # one hop of reachability
                self.regions.append(
                    (list(fn.body), fn, module.symbol_for(fn))
                )

    def __iter__(self):
        return iter(self.regions)


@register
class HostSyncInHotLoop(Rule):
    name = "host-sync-in-hot-loop"
    description = (
        "card->host sync (.item()/.tolist()/.cpu()/.numpy()/float() on a "
        "card value, torch.cuda.synchronize(), stream/event "
        ".synchronize()) inside a step/decode loop stalls the launch queue"
    )

    def check(self, module: Module) -> Iterator[Finding]:
        patterns = _hot_patterns(self.config)
        seen: Set[Tuple[int, int]] = set()
        # dict-subscript provenance through card-returning calls: `state,
        # m = trainer.step(state, b)` with `step` in device_step_methods
        # marks m card-resident, so `float(m["loss"])` in the loop is
        # caught
        targets = astutil.device_call_targets(module)
        device_methods = tuple(
            self.config.get("device_step_methods") or ()
        )
        for body, fn, label in _HotRegions(module, patterns):
            prov = astutil.Provenance(
                module, fn,
                device_call_targets=targets,
                device_methods=device_methods,
            )
            for node in astutil.walk_no_nested_funcs(body):
                if not isinstance(node, ast.Call):
                    continue
                key = (node.lineno, node.col_offset)
                if key in seen:
                    continue
                msg = self._classify(module, prov, node, label)
                if msg:
                    seen.add(key)
                    yield module.finding(self.name, node, msg)

    def _classify(self, module: Module, prov: astutil.Provenance,
                  node: ast.Call, label: str) -> Optional[str]:
        qual = module.resolve(node.func) or ""
        if qual in _ALWAYS_SYNC:
            return (f"{qual}() blocks on every queued kernel inside hot "
                    f"path '{label}': move it out of the loop or wait on "
                    f"one event")
        if isinstance(node.func, ast.Attribute):
            meth = node.func.attr
            if meth in _ALWAYS_SYNC_METHODS:
                return (f".{meth}() inside hot path '{label}' blocks the "
                        f"host on the card: drop it or hoist it out of "
                        f"the loop")
            if meth in _GATED_METHODS:
                if prov.classify(node.func.value) == "device":
                    return (f".{meth}() on a card value inside hot path "
                            f"'{label}' forces a card->host sync per "
                            f"iteration")
        if qual in _GATED_CALLS and node.args:
            if prov.classify(node.args[0]) == "device":
                return (f"{qual}() on a card value inside hot path "
                        f"'{label}' forces a card->host sync per "
                        f"iteration: keep it on the card or batch the "
                        f"transfer")
        return None


@register
class CommStaging(Rule):
    name = "comm-staging"
    description = (
        "fresh torch.tensor()/torch.as_tensor([...])/np.array() built "
        "inline as a collective argument re-stages a host buffer every "
        "call: stage sizes as python ints or prebuilt buffers"
    )

    def check(self, module: Module) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            verb = collective_verb(module, node)
            if verb is None:
                continue
            for arg in astutil.call_args(node):
                if not isinstance(arg, ast.Call):
                    continue
                arg_qual = module.resolve(arg.func) or ""
                staged = arg_qual in _STAGING_CALLS or (
                    arg_qual == "torch.as_tensor" and arg.args
                    and isinstance(arg.args[0], (ast.List, ast.Tuple)))
                if staged:
                    yield module.finding(
                        self.name, arg,
                        f"{arg_qual}() built inline in {verb}() stages "
                        f"a fresh host buffer per collective call: "
                        f"pre-build the buffer (or pass python ints) and "
                        f"reuse it",
                    )
