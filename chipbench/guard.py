"""The modules a run of the port must not load: JAX, its libraries and the
JAX package ``repro``, compared by whole top-level names (the part before
the first dot), so that the port ``repro_torch`` is not mistaken for it."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def forbidden(names: Iterable[str]) -> List[str]:
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)


def loaded() -> List[str]:
    """The forbidden top-level modules in this process's ``sys.modules``."""
    return forbidden(list(sys.modules))
