"""PyTorch/CUDA port of ``cmdgen_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, with the same module names so each
counterpart is easy to find. It imports ``torch``, numpy, scipy and the
standard library (and matplotlib, imageio or PIL inside the GIF renderer);
what it needs from the JAX package's host code it keeps as its own copy. The two EGNN kernels are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built with ``nvcc`` at first use (``ops/_build.py``); the
host helper ``csrc/chemops.cpp`` is built with ``g++`` (``chem/native.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
