"""darwin-tpu's overlap pipeline in PyTorch, with hand-written CUDA
kernels for Hopper (sm_90a).

The JAX package ``darwin_tpu`` is the reference this package is held
against.  The host layer (FASTA, 2-bit coding, minimizers, seed table,
native C++ D-SOFT, record formatting) is shared with it through its
jax-free modules; this package never imports ``jax``.  Module paths
mirror ``darwin_tpu/``: ``ops/`` holds the tile kernels and their plain
PyTorch versions, ``engine/`` the GACT slot loop, ``pipeline.py`` and
``cli.py`` the entry points.

Every function that touches tensors takes an explicit ``device``; a
CPU tensor runs a kernel's plain version, a CUDA tensor launches the
kernel (built from ``csrc/`` at first use, see ``_build.py``).
"""

from darwin_tpu import Params  # importing darwin_tpu arms its THP guard

__all__ = ["Params"]
