"""Native C++ builder equivalence vs the NumPy fallbacks."""

import os

import numpy as np
import pytest

import vulkan_raytracer.accel.native as native_mod
from vulkan_raytracer.accel.bvh import build_bvh
from vulkan_raytracer.accel.grid import build_grid


def _tris(n=1200, seed=2):
    r = np.random.default_rng(seed)
    base = r.uniform(-5, 5, (n, 3)).astype(np.float32)
    return base, base + r.normal(0, 0.3, (n, 3)).astype(np.float32), base + r.normal(
        0, 0.3, (n, 3)
    ).astype(np.float32)


@pytest.fixture
def toggle_native():
    """Force-reset the native loader between variants."""

    def reset(disable: bool):
        if disable:
            os.environ["VKRT_DISABLE_NATIVE"] = "1"
        else:
            os.environ.pop("VKRT_DISABLE_NATIVE", None)
        native_mod._tried = False
        native_mod._lib = None

    yield reset
    reset(False)


def test_native_grid_matches_numpy(toggle_native):
    v0, v1, v2 = _tris()
    toggle_native(False)
    if native_mod.get_lib() is None:
        pytest.skip("no native toolchain")
    g_nat = build_grid(v0, v1, v2)
    toggle_native(True)
    g_np = build_grid(v0, v1, v2)
    assert g_nat.res == g_np.res
    np.testing.assert_array_equal(
        np.asarray(g_nat.cell_start), np.asarray(g_np.cell_start)
    )
    sn, en = np.asarray(g_nat.cell_start), np.asarray(g_nat.tri_ids)
    sp = np.asarray(g_np.tri_ids)
    for c in range(0, len(sn) - 1, 97):  # spot-check cells as sets
        a, b = sn[c], sn[c + 1]
        assert sorted(en[a:b].tolist()) == sorted(sp[a:b].tolist())


def test_native_bvh_valid_topology(toggle_native):
    v0, v1, v2 = _tris(700, 5)
    toggle_native(False)
    if native_mod.get_lib() is None:
        pytest.skip("no native toolchain")
    b = build_bvh(v0, v1, v2, leaf_size=8)
    ids = np.asarray(b.tri_id)
    assert sorted(ids[ids >= 0].tolist()) == list(range(700))
    miss = np.asarray(b.miss)
    n = b.num_nodes
    assert (miss > np.arange(n)).all() and (miss <= n).all()
    first = np.asarray(b.first_tri)
    leaf_first = first[first >= 0]
    assert (leaf_first % 8 == 0).all()
