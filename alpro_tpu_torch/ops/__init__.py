"""Plain ops (LayerNorm, GELU, attention) and the CUDA kernel wrappers."""
