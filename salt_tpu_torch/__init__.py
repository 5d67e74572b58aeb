"""salt_tpu_torch — the salt_tpu aligner on PyTorch and CUDA.

A port of `salt_tpu`'s alignment paths in full suffix-array mode on one
unsharded index: single-end with Landau-Vishkin or Smith-Waterman
extension, and paired-end with mate rescue.  Tensor code is plain
PyTorch; the banded LV distance (`csrc/lv.cu`) and the batched
Smith-Waterman score (`csrc/sw.cu`) are hand-written CUDA kernels for
Hopper.  Every stage takes an explicit `device`; the same code runs on
the CPU, where each kernel's plain PyTorch version stands in for it.

The package stands on its own modules: it imports neither jax nor any
module of salt_tpu.
"""

__version__ = "0.2.0"

import os as _os


def _tune_host_alloc() -> None:
    """Disable numpy's madvise(MADV_HUGEPAGE) on large allocations.

    On kernels with THP defrag=madvise, numpy's default hugepage hint
    makes every first-touch fault do synchronous compaction, which
    slows the fill of the 67 MB 4^12 k-mer lookup tables of the index
    build by orders of magnitude against plain 4K faults.  Opt back
    into numpy's default with SALT_TPU_MADVISE_HUGEPAGE=1.
    """
    if _os.environ.get("SALT_TPU_MADVISE_HUGEPAGE") == "1":
        return
    _os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")
    try:  # numpy may already be imported: flip the live setting
        import numpy as _np

        _mod = getattr(_np, "_core", None) or _np.core
        _mod.multiarray._set_madvise_hugepage(False)
    except Exception:  # pragma: no cover - best effort
        pass


_tune_host_alloc()
