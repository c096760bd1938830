"""The import guard: a run fails if the JAX side was loaded.

Names are compared by their top-level part (before the first dot),
whole: ``repro_torch`` is the port and passes, ``repro`` is the JAX
package and fails.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden_modules(modules=None) -> list[str]:
    """Sorted forbidden top-level names among ``modules`` (default:
    this process's ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".", 1)[0] for name in names} & FORBIDDEN)
