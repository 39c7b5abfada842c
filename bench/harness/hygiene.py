"""The modules a run of the benchmark must not hold: JAX and the JAX
package the program was ported from. Compared by whole top-level name, so
`repro_torch` (the program) is not `repro`."""
from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(module_names: Iterable[str],
              banned: Iterable[str] = FORBIDDEN) -> List[str]:
    """The banned top-level names among `module_names`, sorted."""
    banned = set(banned)
    return sorted({top_level(n) for n in module_names} & banned)
