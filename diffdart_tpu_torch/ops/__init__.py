"""Element algebra and kernels. Counterpart of diffdart_tpu/ops/; so far
tile.py and the fused step (fused_step.py, csrc/fused_step.cu, built by
_build.py). The LCP solvers (lcp*.py), pallas_lcp.py, smalllinalg.py and
native_lcp.py are not ported yet."""
