"""``collective-axis-mismatch``: literal axis names that no mesh declares.

Port of ``pytorch_distributed_tpu/analysis/rules/collectives.py``. In the
port a collective runs on a mesh axis's process group, looked up by name:
``mesh.get_group("dp")``, ``mesh.size("tp")``, or an ``ops.collectives``
function given ``(x, mesh, "dp")``. A typo'd name (``"pd"``) raises at
best; where two meshes share a run it can name another mesh's axis and
reduce over the wrong ranks, which a one-rank CPU test does not see. The
rule collects every axis name the file declares (the axis names of its
``init_device_mesh`` / ``init_hybrid_mesh`` calls) plus the configured
``known_axes``, and flags literal axis arguments outside that vocabulary.
The reference's check against an enclosing ``pmap``'s axis has no
counterpart: the port has no mapped function.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional, Set

from pytorch_distributed_tpu_torch.analysis import astutil
from pytorch_distributed_tpu_torch.analysis.core import (
    Finding, Module, Rule, register,
)

#: ``ops/collectives.py`` function -> positional index of its axis
OPS_AXIS_ARG = {
    "all_reduce": 2, "all_gather": 2, "reduce_scatter": 2, "broadcast": 2,
    "all_to_all": 2, "permute": 2, "send_to": 2, "recv_from": 2,
    "axis_index": 1, "axis_size": 1, "barrier": 1,
}
#: ``DeviceMesh`` methods that take an axis first
MESH_AXIS_METHODS = {"get_group", "size", "get_local_rank"}
#: calls whose string arguments declare mesh axes
MESH_BUILDERS = {"init_device_mesh", "init_hybrid_mesh", "DeviceMesh"}


def _declared_axes(module: Module) -> Set[str]:
    """Axis names the file itself declares: its meshes' axis names."""
    axes: Set[str] = set()
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        qual = module.resolve(node.func) or ""
        if qual.split(".")[-1] not in MESH_BUILDERS:
            continue
        for arg in node.args:
            axes.update(astutil.str_consts(arg))
        for kw in node.keywords:
            if kw.arg in ("axis_names", "mesh_dim_names"):
                axes.update(astutil.str_consts(kw.value))
    return axes


def _axis_node(module: Module, node: ast.Call) -> Optional[ast.AST]:
    """The axis argument of a mesh-axis call, or None."""
    qual = module.resolve(node.func) or ""
    mod, _, name = qual.rpartition(".")
    idx = None
    if mod.split(".")[-1] == "collectives" and name in OPS_AXIS_ARG:
        idx = OPS_AXIS_ARG[name]
    elif (isinstance(node.func, ast.Attribute)
          and node.func.attr in MESH_AXIS_METHODS):
        idx = 0
    if idx is None:
        return None
    if len(node.args) > idx:
        return node.args[idx]
    return astutil.kwarg(node, "axis")


@register
class CollectiveAxisMismatch(Rule):
    name = "collective-axis-mismatch"
    description = (
        "mesh axis name given to an ops.collectives function, "
        "mesh.get_group() or mesh.size() that no mesh in the file and no "
        "known_axes entry declares: a typo'd axis reduces over the wrong "
        "group or fails at run time"
    )

    def check(self, module: Module) -> Iterator[Finding]:
        known = set(self.config.get("known_axes") or ())
        known |= _declared_axes(module)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            axis_node = _axis_node(module, node)
            if axis_node is None:
                continue
            literals = astutil.str_consts(axis_node)
            call = module.dotted(node.func) or "call"
            for ax in literals:   # a dynamic axis expr can't be checked
                if ax not in known:
                    yield module.finding(
                        self.name, node,
                        f"{call}() axis {ax!r} is not declared by any "
                        f"mesh in this file nor in known_axes (likely a "
                        f"typo; declare it in [tool.graftlint-torch] "
                        f"known_axes if real)",
                    )
