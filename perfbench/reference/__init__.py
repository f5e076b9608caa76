"""Plain PyTorch reference of DiffPhar's stage-1 samplers: the EGNN denoiser,
the conditional model's reverse chain (``sampler``) and the joint model's
RePaint inpainting (``joint``), in float32 with TF32 off.

It reads a configuration file of ``perfbench/configs`` and the weights as
flattened flax leaves (``a/b/kernel`` [in, out], ``a/b/bias``), and imports
nothing of the program under test.
"""
