"""The modules a run may not hold: JAX and the JAX package the port was
made from.  Names are compared whole, by their top-level part (before the
first dot), so the port's package, whose name begins with the JAX
package's, passes."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "centerpose_tpu")


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: those
    ``sys.modules`` holds), sorted."""
    names = sys.modules if modules is None else modules
    top = {m.split(".", 1)[0] for m in names}
    return sorted(top & set(FORBIDDEN))
