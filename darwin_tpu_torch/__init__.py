"""darwin-tpu's overlap pipeline in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

The JAX package ``darwin_tpu`` is the reference this package is held
against (by the tests only).  This package imports nothing of it and
never imports ``jax``: the host layer (FASTA, 2-bit coding, minimizers,
seed table, genome layout, host D-SOFT, record formatting) is its own
copy, and the native C++ host library is built from its own copy of
the source.  Module paths mirror ``darwin_tpu/``: ``ops/`` holds the
tile kernels and their plain PyTorch versions, ``engine/`` the GACT
slot loop, ``pipeline.py`` and ``cli.py`` the entry points.

Every function that touches tensors takes an explicit ``device``; a
CPU tensor runs a kernel's plain version, a CUDA tensor launches the
kernel (built from ``csrc/`` at first use, see ``_build.py``).
"""


def _disable_numpy_hugepage_madvise() -> None:
    """Keep numpy from MADV_HUGEPAGE-ing large allocations.

    Under THP defrag=madvise, every first touch of a hugepage-madvised
    region runs synchronous compaction (7-22 s per fresh 250 MB numpy
    array, against 0.2 s without the madvise, on the host the JAX
    package measured it on): a large tax on the genome-scale buffers
    (banks, seed-table keys).  Set DARWIN_TPU_HUGEPAGE=1 to keep numpy's
    default.  (darwin_tpu/__init__.py's guard, copied.)
    """
    import os

    if os.environ.get("DARWIN_TPU_HUGEPAGE") == "1":
        return
    os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    try:  # numpy may already be imported with madvise armed
        from numpy._core import multiarray as _ma
        _ma._set_madvise_hugepage(False)
    except (ImportError, AttributeError):  # another numpy layout
        pass


_disable_numpy_hugepage_madvise()

from darwin_tpu_torch.config import Params  # noqa: E402

__all__ = ["Params"]
