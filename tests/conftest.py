"""Test-session configuration.

Gives the suite 4 host devices so the sharding/compression/pipeline-parallel
tests run instead of skipping.  This must happen before jax initializes.
(The multi-pod dry-run sets its own 512-device flag in its own process —
see repro/launch/dryrun.py — and is unaffected by this.)
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels); skips without one")
