"""The benchmark of the PyTorch and CUDA port, ``cmdgen_tpu_torch``: see
``run.py``."""
