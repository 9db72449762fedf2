"""PyTorch + CUDA port of the COMET W4A4KV4 serving system (NVIDIA Hopper).

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``core``, ``kernels``, ``layers``, ``models``,
``serving``, ``launch``) and never imports it or JAX. Plain tensor code is
PyTorch; every Pallas kernel is a hand-written CUDA kernel for ``sm_90a``
(sources under ``csrc/``, built on first use by ``kernels/_build.py``), each
with a plain PyTorch version beside it that CPU tensors take.
"""
