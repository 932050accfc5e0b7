"""Plain PyTorch reference of the tracker's step; imports nothing of the
program and nothing of JAX."""
