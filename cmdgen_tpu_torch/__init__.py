"""PyTorch/CUDA port of ``cmdgen_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find. It imports ``torch``, numpy and the standard
library only; what it needs from the JAX package's host code it keeps as its
own copy. The two EGNN kernels are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use (``ops/_build.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
