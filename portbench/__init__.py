"""The benchmark of dinov2_tpu_torch on one CUDA card (see run.py)."""
