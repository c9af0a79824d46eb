"""The import check: no JAX, and no JAX package, in a benchmark process.

Names are compared by their top-level part (before the first dot) whole:
the port's package, ``pytorch_distributed_tpu_torch``, begins with the
JAX package's name and is allowed.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_distributed_tpu")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The loaded modules (``sys.modules`` by default) whose top-level
    name is one of :data:`FORBIDDEN`, sorted."""
    if names is None:
        names = list(sys.modules)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
