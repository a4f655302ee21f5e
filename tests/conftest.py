"""Test configuration: force CPU with 8 virtual devices.

Tests run on a virtual 8-device CPU mesh (the standard JAX recipe for
exercising multi-device sharding without hardware — SURVEY.md §4); the GPU
is exercised by ``chip_smoke.py``.  Must run before jax initialises.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vulkan_raytracer.utils.cache import setup_compile_cache  # noqa: E402

setup_compile_cache()


import pytest  # noqa: E402


@pytest.fixture
def bvh_kernel_path(monkeypatch):
    """Route every flat scene past the dense fold to the BVH walk, and run
    that walk through the Pallas interpreter (the kernel the GPU compiles).
    Compiled-function caches are cleared on both sides so no program traced
    under another dispatch is reused."""
    import jax

    from vulkan_raytracer.ops import bvh_kernel
    from vulkan_raytracer.render import integrator

    jax.clear_caches()
    monkeypatch.setattr(integrator, "DENSE_MAX_TRIS", 0)
    monkeypatch.setattr(bvh_kernel, "kernel_mode", lambda: "interpret")
    yield
    jax.clear_caches()
