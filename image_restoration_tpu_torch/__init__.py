"""image_restoration_tpu_torch — the PyTorch/CUDA port of image_restoration_tpu.

The JAX package beside it is the reference: every module here is held to its
JAX counterpart by the CPU tests (``tests/test_torch_*.py``), and every
hand-written CUDA kernel to its plain PyTorch version by ``chip_smoke.py`` on
the GPU. This package imports ``torch`` and never ``jax``.

Layout mirrors the JAX package: ``ops/`` (block library), ``kernels/`` (CUDA
kernels and their plain versions), ``models/``, ``utils/``, ``eval/`` and
``cli/``. Modules take NCHW tensors like the reference torch models and run
their activations as ``channels_last``; kernel functions take (B, H, W, C).
"""

__version__ = "0.1.0"
