"""The no-JAX check: the run's process must not hold JAX or the JAX
package.  Module names are compared by their top-level name, the part
before the first dot, as whole names: ``mageslam_tpu_torch`` (the
program) is not ``mageslam_tpu`` (the JAX package it was ported from)."""

from __future__ import annotations

BANNED = frozenset({"jax", "jaxlib", "flax", "mageslam_tpu"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_banned(modules) -> list:
    """Sorted top-level names in ``modules`` (e.g. ``sys.modules``) that
    are banned."""
    return sorted({top_level(n) for n in modules} & BANNED)
