"""BVH traversal kernel (ops/bvh_kernel.py) against the XLA reference walk.

The kernel runs here through the Pallas interpreter (``interpret=True``),
the same kernel body the GPU compiles through Triton; the plain reference is
:func:`trace_closest` / :func:`trace_shadow` over the same BVH.  Also pinned:
the packed node/triangle rows the kernel reads, the per-backend dispatch,
the compile-cache placement, and the chip smoke's result line.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vulkan_raytracer.accel.bvh import build_bvh, refit_bvh
from vulkan_raytracer.ops import bvh_kernel
from vulkan_raytracer.ops.bvh_kernel import kernel_closest, kernel_shadow
from vulkan_raytracer.ops.math3 import V3
from vulkan_raytracer.ops.traverse import trace_closest, trace_shadow

# small blocks keep the interpreter quick and give several programs per call
BLOCK = 32


def _soup(n, seed=0, leaf_size=4):
    r = np.random.default_rng(seed)
    base = r.uniform(-2.0, 2.0, (n, 3)).astype(np.float32)
    v1 = base + r.normal(0, 0.5, (n, 3)).astype(np.float32)
    v2 = base + r.normal(0, 0.5, (n, 3)).astype(np.float32)
    return build_bvh(base, v1, v2, leaf_size=leaf_size), (base, v1, v2)


def _rays(n, seed=1, extent=3.0):
    r = np.random.default_rng(seed)
    o = r.uniform(-extent, extent, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def _closest_pair(bvh, o, d, t_min, t_max, active):
    got = kernel_closest(bvh, o, d, t_min=t_min, t_max=t_max, active=active,
                         interpret=True, block=BLOCK)
    (t, tri, u, v), _ = trace_closest(bvh, o, d, t_min=t_min, t_max=t_max,
                                      active=active)
    return [np.asarray(x) for x in got], [np.asarray(x) for x in (t, tri, u, v)]


def _assert_same_hits(got, ref):
    tk, trik, uk, vk = got
    tr, trir, ur, vr = ref
    # same visiting order and tie rule as the reference walk: identical ids
    np.testing.assert_array_equal(trik, trir)
    hit = trir >= 0
    assert np.isinf(tk[~hit]).all()
    np.testing.assert_allclose(tk[hit], tr[hit], rtol=1e-6)
    np.testing.assert_allclose(uk[hit], ur[hit], atol=1e-5)
    np.testing.assert_allclose(vk[hit], vr[hit], atol=1e-5)


@pytest.mark.parametrize("leaf_size", [1, 2, 4, 8, 16])
def test_closest_matches_reference_walk(leaf_size):
    bvh, _ = _soup(300, seed=0, leaf_size=leaf_size)
    o, d = _rays(160)
    act = jnp.asarray(np.arange(160) % 7 != 0)
    got, ref = _closest_pair(bvh, o, d, 1e-7, 1e32, act)
    assert (ref[1] >= 0).sum() > 20  # the rays really hit the soup
    _assert_same_hits(got, ref)


def test_shadow_matches_reference_walk():
    bvh, _ = _soup(300, seed=2)
    o, d = _rays(160, seed=3)
    r = np.random.default_rng(4)
    t_max = jnp.asarray(r.uniform(0.05, 4.0, 160).astype(np.float32))
    act = jnp.asarray(np.arange(160) % 5 != 0)
    occ = kernel_shadow(bvh, o, d, t_max=t_max, active=act, interpret=True,
                        block=BLOCK)
    ref, _ = trace_shadow(bvh, o, d, t_max=t_max, active=act)
    occ, ref = np.asarray(occ), np.asarray(ref)
    assert 0 < ref.sum() < ref.size  # both outcomes present
    np.testing.assert_array_equal(occ, ref)
    assert not occ[~np.asarray(act)].any()


def test_per_lane_t_interval():
    """Per-lane t_min (the alpha resample loop) and t_max bound the hit."""
    bvh, _ = _soup(300, seed=5)
    o, d = _rays(128, seed=6)
    r = np.random.default_rng(7)
    t_min = jnp.asarray(r.uniform(0.0, 1.5, 128).astype(np.float32))
    t_max = jnp.asarray(r.uniform(1.0, 5.0, 128).astype(np.float32))
    act = jnp.ones((128,), bool)
    got, ref = _closest_pair(bvh, o, d, t_min, t_max, act)
    _assert_same_hits(got, ref)
    hit = got[1] >= 0
    assert hit.any()
    assert (got[0][hit] > np.asarray(t_min)[hit]).all()
    assert (got[0][hit] <= np.asarray(t_max)[hit]).all()


@pytest.mark.parametrize("n", [1, BLOCK - 1, 2 * BLOCK + 5])
def test_lane_counts_off_the_block(n):
    """Lane counts that are not a multiple of the block: padding lanes are
    dead and sliced off; live lanes still match the reference."""
    bvh, _ = _soup(200, seed=8)
    o, d = _rays(n, seed=9, extent=1.0)
    act = jnp.ones((n,), bool)
    got, ref = _closest_pair(bvh, o, d, 1e-7, 1e32, act)
    assert got[0].shape == (n,) and got[1].dtype == np.int32
    _assert_same_hits(got, ref)


def test_inactive_lanes_report_miss():
    bvh, _ = _soup(200, seed=10)
    o, d = _rays(64, seed=11, extent=1.0)
    act = jnp.zeros((64,), bool)
    t, tri, u, v = (np.asarray(x) for x in kernel_closest(
        bvh, o, d, t_min=1e-7, t_max=1e32, active=act, interpret=True,
        block=BLOCK))
    assert (tri == -1).all() and np.isinf(t).all()
    assert (u == 0).all() and (v == 0).all()
    occ = kernel_shadow(bvh, o, d, t_max=1e32, active=act, interpret=True,
                        block=BLOCK)
    assert not np.asarray(occ).any()


def test_all_miss_rays():
    """Rays that leave the scene's bounds never report a hit."""
    bvh, _ = _soup(200, seed=12)
    n = 48
    o = jnp.tile(jnp.asarray([[0.0, 10.0, 0.0]], jnp.float32), (n, 1))
    r = np.random.default_rng(13)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] = np.abs(d[:, 1]) + 0.1  # all pointing away (up)
    d = jnp.asarray(d / np.linalg.norm(d, axis=-1, keepdims=True))
    act = jnp.ones((n,), bool)
    got, ref = _closest_pair(bvh, o, d, 1e-7, 1e32, act)
    assert (got[1] == -1).all() and np.isinf(got[0]).all()
    _assert_same_hits(got, ref)


def test_accepts_component_rays():
    """The integrator passes V3 component triples; (N, 3) arrays are the
    same rays."""
    bvh, _ = _soup(200, seed=14)
    o, d = _rays(40, seed=15, extent=1.0)
    act = jnp.ones((40,), bool)
    ov = V3(o[:, 0], o[:, 1], o[:, 2])
    dv = V3(d[:, 0], d[:, 1], d[:, 2])
    a = kernel_closest(bvh, ov, dv, t_min=1e-7, t_max=1e32, active=act,
                       interpret=True, block=BLOCK)
    b = kernel_closest(bvh, o, d, t_min=1e-7, t_max=1e32, active=act,
                       interpret=True, block=BLOCK)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("leaf_size", [1, 4, 16])
def test_packed_rows_encode_the_tree(leaf_size):
    """node_rows carry [min, max, first|(count-1), miss]; tri_rows the
    per-slot [v0, e1, e2] — the layout the kernel decodes."""
    bvh, _ = _soup(150, seed=16, leaf_size=leaf_size)
    rows = np.asarray(bvh.node_rows)
    assert rows.shape == (bvh.num_nodes, 8) and rows.dtype == np.float32
    np.testing.assert_array_equal(rows[:, :3], np.asarray(bvh.aabb_min))
    np.testing.assert_array_equal(rows[:, 3:6], np.asarray(bvh.aabb_max))
    code = rows[:, 6].view(np.int32)
    miss = rows[:, 7].view(np.int32)
    np.testing.assert_array_equal(miss, np.asarray(bvh.miss))
    first = np.asarray(bvh.first_tri)
    leaf = first >= 0
    np.testing.assert_array_equal(code[~leaf], -1)
    np.testing.assert_array_equal(code[leaf] & ~(leaf_size - 1), first[leaf])
    slots = np.asarray(bvh.tri_id).reshape(-1, leaf_size)
    count = (code[leaf] & (leaf_size - 1)) + 1
    np.testing.assert_array_equal(count, (slots[first[leaf] // leaf_size] >= 0).sum(1))
    tri = np.asarray(bvh.tri_rows)
    np.testing.assert_array_equal(tri[:, :3], np.asarray(bvh.tri_v0))
    np.testing.assert_array_equal(tri[:, 6:], np.asarray(bvh.tri_e2))


def test_refit_repacks_rows():
    """refit_bvh with unchanged vertices reproduces the build's rows, and
    moved vertices move the packed rows with them."""
    bvh, (v0, v1, v2) = _soup(120, seed=17)
    same = refit_bvh(bvh, v0, v1, v2)
    np.testing.assert_array_equal(np.asarray(same.node_rows),
                                  np.asarray(bvh.node_rows))
    np.testing.assert_array_equal(np.asarray(same.tri_rows),
                                  np.asarray(bvh.tri_rows))
    shift = np.float32([0.5, 0.0, 0.0])
    moved = refit_bvh(bvh, v0 + shift, v1 + shift, v2 + shift)
    np.testing.assert_allclose(np.asarray(moved.node_rows)[:, 0],
                               np.asarray(bvh.node_rows)[:, 0] + 0.5, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(moved.node_rows)[:, 6:],
                                  np.asarray(bvh.node_rows)[:, 6:])


def test_leaf_size_must_be_power_of_two():
    v = np.zeros((4, 3), np.float32)
    with pytest.raises(ValueError, match="power of two"):
        build_bvh(v, v + 1, v + 2, leaf_size=6)


@pytest.mark.parametrize("backend,mode", [("gpu", "compiled"), ("cpu", None)])
def test_dispatch_per_backend(monkeypatch, backend, mode):
    """A GPU backend always takes the compiled kernel; anything else runs
    the XLA reference walk."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert bvh_kernel.kernel_mode() == mode

    calls = []

    def fake_kernel(bvh, o, d, **kw):
        calls.append(kw)
        n = o.x.shape[0]
        return (jnp.full((n,), jnp.inf), jnp.full((n,), -1, jnp.int32),
                jnp.zeros((n,)), jnp.zeros((n,)))

    monkeypatch.setattr(bvh_kernel, "kernel_closest", fake_kernel)
    bvh, _ = _soup(50, seed=18)
    o, d = _rays(8, seed=19)
    ov, dv = V3(o[:, 0], o[:, 1], o[:, 2]), V3(d[:, 0], d[:, 1], d[:, 2])
    bvh_kernel.bvh_closest(bvh, ov, dv, t_min=1e-7, t_max=1e32,
                           active=jnp.ones((8,), bool))
    if mode == "compiled":
        assert len(calls) == 1 and calls[0]["interpret"] is False
    else:
        assert calls == []


def test_alpha_resample_loop_through_kernel(bvh_kernel_path, monkeypatch):
    """The integrator's any-hit resample loop re-traces past rejected
    candidates with per-lane t_min; through the kernel it must give the
    dense fold's answer (MASK-only alpha: no RNG involved)."""
    from vulkan_raytracer.render.integrator import _closest
    from vulkan_raytracer.render import integrator
    from test_alpha import _alpha_scene, _rays as alpha_rays

    tables = _alpha_scene(with_blend=False).upload()
    assert tables.has_alpha
    o, d = alpha_rays(64, seed=21)
    ov = V3(*(jnp.asarray(o[:, k]) for k in range(3)))
    dv = V3(*(jnp.asarray(d[:, k]) for k in range(3)))
    seeds = jnp.arange(64, dtype=jnp.uint32)
    act = jnp.ones((64,), bool)
    (tk, trik, _, _), _ = _closest(tables, ov, dv, t_min=1e-6, t_max=1e32,
                                   active=act, seed=seeds)
    monkeypatch.setattr(integrator, "DENSE_MAX_TRIS", 1 << 30)  # dense fold
    (td, trid, _, _), _ = _closest(tables, ov, dv, t_min=1e-6, t_max=1e32,
                                   active=act, seed=seeds)
    trik, trid = np.asarray(trik), np.asarray(trid)
    np.testing.assert_array_equal(trik, trid)
    hit = trid >= 0
    assert hit.any()
    np.testing.assert_allclose(np.asarray(tk)[hit], np.asarray(td)[hit],
                               rtol=1e-5)


def test_instanced_blas_through_kernel(monkeypatch):
    """Instanced prototypes above DENSE_MAX_TRIS walk their BLAS with the
    kernel; the hits equal the reference walk's on the same tables."""
    from vulkan_raytracer.ops.instanced import instanced_closest, instanced_shadow
    from vulkan_raytracer.scene import scenegraph as sg
    from test_instancing import _instanced_scene

    monkeypatch.setattr(sg, "DENSE_MAX_TRIS", 50)  # soup prototype: 120 tris
    ti = _instanced_scene(n_soup_instances=2).upload(instancing=True)
    assert ti.inst.groups[0].blas is not None
    r = np.random.default_rng(22)
    n = 64
    ang = r.uniform(0, 2 * np.pi, n)
    o = np.stack([4.5 * np.cos(ang), r.uniform(-0.5, 2.5, n),
                  4.5 * np.sin(ang) - 0.7], axis=1).astype(np.float32)
    d = r.uniform(-1.5, 1.5, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ov = V3(*(jnp.asarray(o[:, k]) for k in range(3)))
    dv = V3(*(jnp.asarray(d[:, k]) for k in range(3)))
    act = jnp.ones((n,), bool)

    monkeypatch.setattr(bvh_kernel, "kernel_mode", lambda: "interpret")
    tk, ek, _, _ = instanced_closest(ti, ov, dv, t_min=1e-3, t_max=1e32,
                                     active=act)
    ok = instanced_shadow(ti, ov, dv, t_max=2.5, active=act)
    monkeypatch.setattr(bvh_kernel, "kernel_mode", lambda: None)
    tr, er, _, _ = instanced_closest(ti, ov, dv, t_min=1e-3, t_max=1e32,
                                     active=act)
    orf = instanced_shadow(ti, ov, dv, t_max=2.5, active=act)
    np.testing.assert_array_equal(np.asarray(ek), np.asarray(er))
    hit = np.asarray(er) >= 0
    assert hit.any()
    np.testing.assert_allclose(np.asarray(tk)[hit], np.asarray(tr)[hit],
                               rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(ok), np.asarray(orf))


@pytest.mark.parametrize("preset", [None, "given"])
def test_compile_cache_placement(monkeypatch, tmp_path, preset):
    """Unset: the cache lives in <checkout>/.jax_cache.  Set: the variable's
    directory is used and no other is configured."""
    from vulkan_raytracer.utils import cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if preset is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            jax.config.update("jax_compilation_cache_dir", None)
            path = cache.setup_compile_cache()
            root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            assert path == os.path.join(root, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
        else:
            given = str(tmp_path / "cache")
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", given)
            jax.config.update("jax_compilation_cache_dir", "sentinel")
            assert cache.setup_compile_cache() == given
            # nothing set in code: the config keeps what JAX read itself
            assert jax.config.jax_compilation_cache_dir == "sentinel"
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_result_line():
    """The smoke's last stdout line is the exact JSON object the driver
    parses."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    line = chip_smoke.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1
