"""Device milliseconds per batch of the convolution / GEMM kernels
(``yardstick.KINDS``: cuDNN, CUTLASS, cuBLAS names) in the profiled tail."""
from cardbench.metrics._common import kind_ms_per_batch


def read(run):
    return kind_ms_per_batch(run, "conv_gemm")
