"""litepi_tpu_torch: the PyTorch / CUDA port of ``litepi_tpu`` for one H100.

The JAX package ``litepi_tpu`` is the reference; this package reproduces its
fused serving program (``pipeline.TwoStagePipeline.run_fused``) in PyTorch,
with the TPU's Pallas kernels replaced by CUDA C++ kernels for ``sm_90a``
(``csrc/``, built at first use by ``kernels.build``).  It imports ``torch``
and numpy, never JAX and nothing of ``litepi_tpu``.

Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; on the CPU every kernel's plain PyTorch version runs instead.
"""

__version__ = "0.1.0"
