"""Random-weight GGUF checkpoints for the port's checks: the JAX package's
`dinov2_tpu.io.synthetic` (numpy only, no jax), re-exported."""

from dinov2_tpu.io.synthetic import write_synthetic_gguf  # noqa: F401
