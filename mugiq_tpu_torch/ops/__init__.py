"""Complex full-site operators of the API path: the Wilson hop, the loop
contraction (plain PyTorch, as the JAX package's XLA forms are)."""
