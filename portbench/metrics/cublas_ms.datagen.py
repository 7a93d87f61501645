"""Device ms a chunk of 256 solves in cuBLAS GEMM and GEMV (the hat transfers)."""
from portbench.harness.readers import cublas_ms as read  # noqa: F401
