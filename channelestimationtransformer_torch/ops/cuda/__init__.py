"""Hand-written CUDA kernels for Hopper and their wrappers (one module per kernel)."""
