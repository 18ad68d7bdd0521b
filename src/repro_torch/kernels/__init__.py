"""The port's GEMM layer: epilogue registry, the O-POPE CUDA kernel with its
plain PyTorch version, and the ``matmul``/``linear`` entry points."""
