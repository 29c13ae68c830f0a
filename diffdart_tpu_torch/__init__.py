"""PyTorch/CUDA port of diffdart_tpu (the JAX package beside it is the
reference). Imports torch, never jax, and nothing of diffdart_tpu."""
