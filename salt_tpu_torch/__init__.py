"""salt_tpu_torch — the salt_tpu aligner on PyTorch and CUDA.

A port of the single-end Landau-Vishkin alignment path of `salt_tpu`
(full suffix-array mode, one unsharded index) to plain PyTorch tensor
code, with the banded LV distance as a hand-written CUDA kernel for
Hopper (`csrc/lv.cu`).  Every stage takes an explicit `device`; the
same code runs on the CPU, where each kernel's plain PyTorch version
stands in for it.

The package never imports jax.  It reuses only salt_tpu's jax-free host
modules: `constants`, `index.{build,store}`, `io.{fasta,sam,snp}`,
`sim.*` and `utils.metrics.{stage,progress}`.
"""

__version__ = "0.1.0"
