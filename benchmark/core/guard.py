"""The port is measured without JAX: no run may hold JAX, its libraries or
the JAX package.

Names are compared whole, by the part before the first dot:
``svd_lstm_tpu_torch`` (the port) begins with ``svd_lstm_tpu`` (the JAX
package) and is allowed.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "svd_lstm_tpu"})
PROGRAM = "svd_lstm_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default:
    ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({top(m) for m in names} & FORBIDDEN)


def imported_tops(path: Path) -> set:
    """Top-level names of the absolute imports of one source file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {top(a.name) for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(top(node.module))
    return out
