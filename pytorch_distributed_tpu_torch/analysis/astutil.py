"""Shared torch-aware AST indexes used by several graftlint rules.

Port of ``pytorch_distributed_tpu/analysis/astutil.py``. Everything here
is best-effort *lexical* analysis: names are resolved through the
module's import table (``torch.nn.functional``/``torch.distributed``/
``numpy`` canonicalized to ``F``/``dist``/``np``) and straight-line
assignments are tracked, but no code runs. Rules built on these helpers
bias toward precision (few false positives) over recall: a value of
unknown provenance never fires a rule that needs a card value.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Sequence, Set

from pytorch_distributed_tpu_torch.analysis.core import Module

#: ``torch.*`` factories: a fresh tensor on the host unless ``device=``
#: names another place (``*_like`` ones follow their first argument)
FACTORIES = {
    "torch.tensor", "torch.as_tensor", "torch.from_numpy", "torch.zeros",
    "torch.ones", "torch.empty", "torch.full", "torch.arange",
    "torch.linspace", "torch.logspace", "torch.eye", "torch.rand",
    "torch.randn", "torch.randint", "torch.randperm", "torch.empty_strided",
    "torch.frombuffer",
}
LIKE_FACTORIES = {
    "torch.zeros_like", "torch.ones_like", "torch.empty_like",
    "torch.full_like", "torch.rand_like", "torch.randn_like",
    "torch.randint_like",
}

#: tensor attributes and methods that answer on the host without a sync
#: (metadata, not data)
HOST_ATTRS = {
    "shape", "dtype", "device", "ndim", "is_cuda", "requires_grad",
    "layout", "names", "is_leaf", "grad_fn",
}
HOST_METHODS = {
    "size", "dim", "numel", "element_size", "data_ptr", "stride",
    "storage_offset", "is_contiguous", "nelement", "get_device",
}
#: methods that bring a card value to the host (the syncs themselves)
TO_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}


def str_const(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def str_consts(node: ast.AST) -> tuple:
    """All string literals directly inside a str/tuple/list literal."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
        return tuple(e.value for e in node.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str))
    return ()


def kwarg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def call_args(call: ast.Call) -> List[ast.AST]:
    """Positional and keyword argument expressions of a call."""
    return list(call.args) + [kw.value for kw in call.keywords]


def names_in(nodes: Sequence[ast.AST]) -> Set[str]:
    """Every name read anywhere under ``nodes``."""
    return {n.id for a in nodes for n in ast.walk(a)
            if isinstance(n, ast.Name)}


def walk_no_nested_funcs(body: Sequence[ast.stmt]) -> Iterator[ast.AST]:
    """Walk statements without descending into nested function/class defs
    (their bodies belong to a different scope)."""
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef, ast.Lambda)):
                continue
            stack.append(child)


def _placement(module: Module, node: ast.AST) -> Optional[str]:
    """What a device argument names: "host" for the literal ``"cpu"`` (or
    ``torch.device("cpu")``), "device" for another literal, a
    ``torch.device(...)`` of one, or a name that reads as a device
    (``device``, ``self.device``, ``dev``); None when it is something else
    (a dtype: ``.to(torch.bfloat16)``)."""
    s = str_const(node)
    if s is not None:
        return "host" if s.split(":")[0] == "cpu" else "device"
    if (isinstance(node, ast.Call)
            and module.resolve(node.func) == "torch.device"):
        return _placement(module, node.args[0]) if node.args else None
    dotted = module.dotted(node) or ""
    tail = dotted.split(".")[-1]
    if tail in ("device", "dev") or tail.endswith("_device"):
        return "device"
    return None


class Provenance:
    """Straight-line name classification inside one function: "device"
    for values on the card, "host" for numpy / python scalars / tensors
    made on the host, None for unknown (e.g. returned by a helper the
    analysis cannot see into). Deliberately conservative: unknown names
    never fire card-only rules.

    A value is card-resident when it comes from

    * a tensor op (``torch.*`` or ``F.*`` that is not a factory, unless
      every argument is on the host), or a method of a card value;
    * ``.to(device)``, ``.cuda()`` or a call with ``device=`` naming the
      card (``torch.zeros(n, device=dev)``, ``GPT2(cfg, device="cuda")``);
    * a module call: calling a value that is itself on the card (a module
      built with ``device=`` or moved by ``.to``/``.cuda``);
    * a call of a card-returning function: a local module-level one, or one
      imported from another analyzed file (``device_call_targets``);
    * a method named in ``device_methods`` (config ``device_step_methods``:
      ``trainer.step(...)``, whose metrics are 0-d tensors on the card),
      whatever its receiver.
    """

    def __init__(self, module: Module, fn: ast.AST, *,
                 device_call_targets: Sequence[str] = (),
                 device_methods: Sequence[str] = ()):
        self.module = module
        self.device_call_targets = set(device_call_targets)
        self.device_methods = set(device_methods)
        self.kinds: dict = {}
        # in source order: a name is classified from what it was bound to
        # before (a module built on the card before the loop that calls it)
        assigns = sorted(
            (n for n in walk_no_nested_funcs(fn.body)
             if isinstance(n, (ast.Assign, ast.AnnAssign))),
            key=lambda n: (n.lineno, n.col_offset))
        for stmt in assigns:
            if isinstance(stmt, ast.Assign):
                kind = self.classify(stmt.value)
                for tgt in stmt.targets:
                    if isinstance(tgt, ast.Name):
                        self.kinds[tgt.id] = kind
                    elif isinstance(tgt, (ast.Tuple, ast.List)):
                        # a card-returning CALL unpacks to card parts (a
                        # step's (state, metrics)); any other right-hand
                        # side stays unknown: a literal-tuple unpack would
                        # misattribute per element
                        part = kind if isinstance(stmt.value, ast.Call) \
                            else None
                        for e in tgt.elts:
                            if isinstance(e, ast.Name):
                                self.kinds[e.id] = part
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                if isinstance(stmt.target, ast.Name):
                    self.kinds[stmt.target.id] = self.classify(stmt.value)

    def _args_kind(self, call: ast.Call) -> Optional[str]:
        kinds = {self.classify(a) for a in call_args(call)}
        if "device" in kinds:
            return "device"
        if kinds == {"host"}:
            return "host"
        return None

    def classify(self, node: ast.AST) -> Optional[str]:
        module = self.module
        if isinstance(node, ast.Constant):
            return "host"
        if isinstance(node, ast.Call):
            qual = module.resolve(node.func) or ""
            if qual.startswith("np.") or qual in ("float", "int", "bool",
                                                  "len", "str"):
                return "host"
            placed = kwarg(node, "device")
            where = None if placed is None else _placement(module, placed)
            if where is not None:
                return where
            if qual in FACTORIES:
                return "host"
            if qual in LIKE_FACTORIES:
                return self.classify(node.args[0]) if node.args else None
            if qual.startswith(("torch.", "F.")) and qual != "torch.device":
                # a tensor op: on the card unless every input is on the
                # host (the port's tensors live on the card)
                return "host" if self._args_kind(node) == "host" \
                    else "device"
            dotted = module.dotted(node.func) or ""
            if dotted and dotted in self.device_call_targets:
                return "device"
            if isinstance(node.func, ast.Attribute):
                meth = node.func.attr
                if meth in TO_HOST_METHODS or meth in HOST_METHODS:
                    return "host"
                if meth == "cuda":
                    return "device"
                if meth == "to":
                    for arg in call_args(node):
                        where = _placement(module, arg)
                        if where is not None:
                            return where
                    return self.classify(node.func.value)
                if meth in self.device_methods:
                    return "device"
                # a method of a card value stays on the card
                return self.classify(node.func.value)
            if isinstance(node.func, ast.Name):
                # a module call: calling a value that lives on the card
                if self.kinds.get(node.func.id) == "device":
                    return "device"
            return None
        if isinstance(node, ast.Name):
            return self.kinds.get(node.id)
        if isinstance(node, ast.Attribute):
            if node.attr in HOST_ATTRS:
                return "host"
            return self.classify(node.value)
        if isinstance(node, (ast.Subscript, ast.Starred)):
            return self.classify(node.value)
        if isinstance(node, ast.BinOp):
            left = self.classify(node.left)
            right = self.classify(node.right)
            if "device" in (left, right):
                return "device"
            if left == right == "host":
                return "host"
            return None
        if isinstance(node, ast.Compare):
            kinds = {self.classify(n) for n in [node.left, *node.comparators]}
            if "device" in kinds:
                return "device"
            return "host" if kinds == {"host"} else None
        if isinstance(node, ast.UnaryOp):
            return self.classify(node.operand)
        if isinstance(node, (ast.Tuple, ast.List)):
            kinds = {self.classify(e) for e in node.elts}
            if kinds == {"host"}:
                return "host"
            if "device" in kinds:
                return "device"
            return None
        return None


def _returns(fn: ast.AST) -> List[ast.Return]:
    return [n for n in walk_no_nested_funcs(fn.body)
            if isinstance(n, ast.Return)]


def device_functions(module: Module) -> Set[str]:
    """Names of the module-level functions whose every ``return`` carries
    a card value (and that return at all): calling one returns a tensor on
    the card. Feeds ``core.ProjectIndex``; decided without the index (one
    level: a function returning another card-returning function's result
    is not followed)."""
    out: Set[str] = set()
    for node in getattr(module.tree, "body", ()):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        rets = [r for r in _returns(node) if r.value is not None]
        if not rets or len(rets) != len(_returns(node)):
            continue
        prov = Provenance(module, node)
        if all(prov.classify(r.value) == "device" for r in rets):
            out.add(node.name)
    return out


def imported_device_names(module: Module) -> Set[str]:
    """Local dotted spellings that resolve, via the project index, to a
    card-returning function of another analyzed file."""
    project = getattr(module, "project", None)
    if project is None:
        return set()
    out: Set[str] = set()
    for alias, full in module.imports.items():
        mod, _, name = full.rpartition(".")
        if mod and project.get(mod, name):
            out.add(alias)               # from m import f [as alias]
        for bound in project.table(full):
            out.add(f"{alias}.{bound}")  # import m [as alias]; m.f(...)
    return out


def device_call_targets(module: Module) -> Set[str]:
    """Names whose call returns a card value: this module's own
    card-returning functions, plus those IMPORTED from other analyzed
    files (via the project index); feed to :class:`Provenance`."""
    return device_functions(module) | imported_device_names(module)
