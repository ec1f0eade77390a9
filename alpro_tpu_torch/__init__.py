"""alpro_tpu_torch — the PyTorch/CUDA port of ``alpro_tpu`` for NVIDIA Hopper.

The JAX package ``alpro_tpu`` is the reference; this package reproduces its
retrieval serving path (TimeSformer-B/16 video tower, BERT-base text and
fusion halves, ``RetrievalIndex``) in PyTorch. The TPU Pallas kernels on that
path are hand-written CUDA C++ kernels under ``csrc/``, built with ``nvcc`` at
first use (``ops/_build.py``). On a CPU tensor every kernel wrapper runs its
plain PyTorch twin instead, so the package imports and runs without a GPU.

Importing this package imports neither jax nor any kernel build.
"""

__version__ = "0.1.0"
