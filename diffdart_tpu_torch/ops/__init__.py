"""Element algebra, small linear algebra, LCP solvers and kernels.
Counterpart of diffdart_tpu/ops/: tile.py, the fused step (fused_step.py,
csrc/fused_step.cu), smalllinalg.py, the LCP solvers of the vmap stack (the
dense boxed_lcp of lcp.py, lcp_lowrank.py, lcp_pivot.py) and its sweep
kernel (pallas_lcp.py, csrc/jacobi_sweeps.cu); the CUDA sources are built by
_build.py. native_lcp.py is not ported yet."""
