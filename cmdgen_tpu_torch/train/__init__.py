"""Training loops, optimizers and checkpoints (counterpart of ``cmdgen_tpu/train``)."""
