"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-chip TPU hardware is not available in CI; sharding semantics are
identical on XLA's host platform, so pjit/shard_map tests run against
8 virtual CPU devices (the TPU-world "fake cluster").

NOTE: in this image, parts of jax are pre-imported at interpreter startup,
so JAX_PLATFORMS/JAX_PLATFORM_NAME set here via os.environ are read too
late. ``jax.config.update`` before first backend use is what reliably
forces the CPU platform; XLA_FLAGS is still honored at backend init.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: runs the port's CUDA kernels on the card; skips where CUDA is absent")
