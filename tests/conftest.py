"""Test configuration: force the CPU backend with 8 virtual devices.

Tests run on CPU (fast eager dispatch + multi-device sharding checks); the
GPU is exercised by ``chip_smoke.py`` and ``bench.py``. Float64 is enabled
to match the reference's test number format (reference tests use Float64,
examples Float32).

``jax.config.update`` is used (not only ``JAX_PLATFORMS``) so the CPU is
forced even when JAX was imported before this file runs.

XLA's CPU fusion emitters are switched off: in jaxlib 0.9.0 they miscompile
parts of the coupled LandModel step (a jitted compute_auxiliary +
compute_tendencies returned zero hydraulic conductivity at two faces that
the eager computation and the other emitters fill) and shift full-carry
`lax.scan` rollouts away from their step-by-step loops.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
if "xla_cpu_use_fusion_emitters" not in flags:
    flags += " --xla_cpu_use_fusion_emitters=false"
os.environ["XLA_FLAGS"] = flags

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
assert jax.devices()[0].platform == "cpu", jax.devices()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (>40 s); skip with -m 'not slow'")
