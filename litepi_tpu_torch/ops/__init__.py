"""Tensor ops of the port.  ``nms``, ``roi`` and ``stem`` dispatch to the
CUDA kernels for CUDA tensors and to their plain versions for CPU tensors."""
