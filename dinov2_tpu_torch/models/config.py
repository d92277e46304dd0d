"""Model configuration of the port: the JAX package's `dinov2_tpu.models.config`,
which is plain Python and imports no jax, re-exported so that users of the
port import only `dinov2_tpu_torch`."""

from dinov2_tpu.models.config import (  # noqa: F401
    IMAGENET_DEFAULT_MEAN,
    IMAGENET_DEFAULT_STD,
    PRESETS,
    DinoConfig,
    id2label_from_kv,
)
