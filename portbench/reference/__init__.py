"""The plain reference: DINOv2 in float32 PyTorch, with no kernel, cache or
batching of the program's, and its own q4_0 codec. It imports nothing of
dinov2_tpu_torch, dinov2_tpu or jax, and takes nothing the program made."""
