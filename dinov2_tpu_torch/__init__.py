"""dinov2_tpu_torch: the PyTorch/CUDA port of dinov2_tpu for one NVIDIA H100.

It keeps the JAX package's module paths and function names, so each port
function sits where its reference does (`models/vit.py::forward_features`,
`ops/fused_attention.py::slab_layer_block`, ...). It imports torch and numpy
and never jax. The JAX package's jax-free host modules (model config, GGUF
reader, synthetic checkpoints, ggml block codecs and quantizer) are
imported, not copied, and re-exported as `models/config.py`, `io/gguf.py`,
`io/synthetic.py` and `quant/__init__.py`: no other module of the port
names `dinov2_tpu`. The hand-written
CUDA kernels live in `csrc/` and are built with nvcc at first use.
"""

__version__ = "0.1.0"
