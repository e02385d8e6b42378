"""centerpose_tpu_torch: the PyTorch + CUDA port of ``centerpose_tpu``.

The same CenterNet-style multi-person pose system, for an NVIDIA H100: the
JAX package beside it stays the reference, and every module here is the
counterpart of the JAX module of the same name.  So far the port covers
dla_34 inference end to end (config, weight bridge, model, decode, detector)
with the om-fused DCNv2 forward as a hand-written CUDA kernel
(``ops/dcn_cuda.py``, ``csrc/dcn_fused.cu``).  Nothing here imports JAX or
the JAX package.
"""

__version__ = "0.1.0"
