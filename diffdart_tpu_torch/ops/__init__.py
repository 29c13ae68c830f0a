"""Element algebra, small linear algebra, LCP solvers and kernels.
Counterpart of diffdart_tpu/ops/: tile.py, the fused step (fused_step.py,
csrc/fused_step.cu), smalllinalg.py, the low-rank LCP of the vmap stack
(lcp.py, lcp_lowrank.py, lcp_pivot.py) and its sweep kernel (pallas_lcp.py,
csrc/jacobi_sweeps.cu); the CUDA sources are built by _build.py.
native_lcp.py and the dense boxed_lcp are not ported yet."""
