"""Tensor ops of the port.  ``nms``, ``roi``, ``stem`` and ``act`` (bf16
SiLU / sigmoid) dispatch to the CUDA kernels for CUDA tensors and to their
plain versions for CPU tensors."""
