"""Which modules a process must not hold.

The benchmark measures the PyTorch and CUDA port alone: a run whose
process holds JAX or the JAX package (darwin_tpu) fails, and the plain
reference holds nothing of the port either.  Names are compared by their
top-level part (before the first dot), whole: darwin_tpu_torch is not
darwin_tpu.
"""

from __future__ import annotations

HARNESS = ("jax", "jaxlib", "flax", "darwin_tpu")
REFERENCE = HARNESS + ("darwin_tpu_torch",)


def forbidden(modules, names) -> list[str]:
    """The top-level names among modules (names or sys.modules) that
    are in names, sorted."""
    return sorted({m.split(".", 1)[0] for m in modules} & set(names))
