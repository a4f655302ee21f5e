#!/usr/bin/env python
"""Traversal measurements on one GPU: the BVH kernel against the XLA walks.

    python tools/measure_traversal.py --check        # compile + one check
    python tools/measure_traversal.py [--out F.jsonl] # full set

``--check`` compiles the kernel at the dragon's real widths (a 2^19-lane
band), compares it once with the reference walk, prints the compiled
kernels' memory analysis and stops.  The full set measures, on the dragon
stand-in (262,280 triangles):

* closest hit on a primary and a first-bounce band and occlusion on a
  shadow band: the kernel, XLA's ``trace_closest`` / ``trace_shadow`` and
  the uniform-grid DDA (``grid_closest`` / ``grid_shadow``);
* the leaf-size sweep 4 / 8 / 16 (kernel per band, and end to end on the
  512x512 4-spp depth-4 dragon frame), plus the XLA walk end to end;
* the kernel's rays-per-program sweep;
* the dense fold against the kernel on random soups of 1k, 12k and 65k
  triangles (the DENSE_MAX_TRIS crossover);
* a profiler trace of the Cornell dense fold and of one Cornell frame,
  reduced to the kernels that ran and their device time.

Every line carries the card's name and power limit.  Times are medians of
``REPS`` runs after one warm-up call (whose time, compile included, is
printed as ``first``).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("VKRT_LOG_LEVEL", "ERROR")

import numpy as np  # noqa: E402

REPS = 5
_OUT = None
_CARD = "?"


def emit(record, **rec):
    rec = dict(record=record, card=_CARD, **rec)
    print(json.dumps(rec), flush=True)
    if _OUT:
        with open(_OUT, "a") as f:
            f.write(json.dumps(rec) + "\n")


def timeit(fn, *args, reps=REPS):
    """(first-call seconds incl. compile, median seconds, min seconds)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)), float(min(ts))


def _dragon(leaf_size):
    import bench
    from vulkan_raytracer.scene.procedural import dragon_scene

    cfg = next(c for c in bench.CONFIGS if c["key"].startswith("cfg2_dragon"))
    return dragon_scene().upload(leaf_size=leaf_size), bench._cam(*cfg["cam"])


def _walkers(bvh, block=None, num_warps=None):
    import jax

    from vulkan_raytracer.ops import bvh_kernel as bk
    from vulkan_raytracer.ops.traverse import trace_closest, trace_shadow

    kw = {}
    if block:
        kw = dict(block=block, num_warps=num_warps)
    return dict(
        kernel_closest=jax.jit(lambda o, d, a, tmin: bk.kernel_closest(
            bvh, o, d, t_min=tmin, t_max=1e32, active=a, **kw)),
        xla_closest=jax.jit(lambda o, d, a, tmin: trace_closest(
            bvh, o, d, t_min=tmin, t_max=1e32, active=a)[0]),
        kernel_shadow=jax.jit(lambda o, d, t, a: bk.kernel_shadow(
            bvh, o, d, t_max=t, active=a, **kw)),
        xla_shadow=jax.jit(lambda o, d, t, a: trace_shadow(
            bvh, o, d, t_max=t, active=a)[0]),
    )


def check() -> None:
    """Compile at real width, compare once, print memory analysis."""
    import jax

    from chip_smoke import Smoke, compare_closest, dragon_band
    from vulkan_raytracer.ops import bvh_kernel as bk

    tables, cam = _dragon(16)
    band = dragon_band(tables, cam)
    sm = Smoke(_CARD)
    o, d, act = band["primary"]
    lowered = jax.jit(lambda o, d, a: bk.kernel_closest(
        tables.bvh, o, d, t_min=1e-7, t_max=1e32, active=a)).lower(o, d, act)
    t0 = time.perf_counter()
    compiled = lowered.compile()
    sm.say(f"kernel_closest compile {time.perf_counter() - t0:.2f} s; "
           f"memory_analysis {compiled.memory_analysis()}")
    agree, live, bad_t, bad_tie, sk, sr = compare_closest(
        tables.bvh, o, d, act, 1e-7)
    sm.say(f"primary ids agree {agree:.6f} over {live} live lanes, bad t "
           f"{bad_t}, non-tie {bad_tie}; kernel {sk * 1e3:.3f} ms, XLA "
           f"{sr * 1e3:.3f} ms")


def measure_leaf(leaf, with_xla):
    from chip_smoke import dragon_band
    from vulkan_raytracer.render.renderer import render_image

    t0 = time.perf_counter()
    tables, cam = _dragon(leaf)
    build = time.perf_counter() - t0
    band = dragon_band(tables, cam)
    bvh = tables.bvh
    emit("bvh", leaf=leaf, nodes=bvh.num_nodes, tri_slots=bvh.num_tri_slots,
         node_bytes=int(bvh.node_rows.nbytes), tri_bytes=int(bvh.tri_rows.nbytes),
         build_s=build)
    w = _walkers(bvh)
    n = int(band["primary"][2].shape[0])
    for name, (o, d, act), tmin in (("primary", band["primary"], 1e-7),
                                    ("bounce", band["bounce"], 1e-4)):
        for impl in ("kernel_closest",) + (("xla_closest",) if with_xla else ()):
            first, med, mn = timeit(w[impl], o, d, act, np.float32(tmin))
            emit("closest", leaf=leaf, wave=name, impl=impl, lanes=n,
                 live=int(np.asarray(act).sum()), first_s=first, median_s=med,
                 min_s=mn, mrays_s=float(np.asarray(act).sum()) / med / 1e6)
    p, sd, dist, act = band["shadow"]
    for impl in ("kernel_shadow",) + (("xla_shadow",) if with_xla else ()):
        first, med, mn = timeit(w[impl], p, sd, dist, act)
        emit("shadow", leaf=leaf, wave="shadow", impl=impl, lanes=n,
             live=int(np.asarray(act).sum()), first_s=first, median_s=med,
             min_s=mn)

    def frame():
        return render_image(tables, cam, 512, 512, spp=4, max_depth=4,
                            tonemap=False)

    t0 = time.perf_counter()
    _, rays = frame()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, rays = frame()
        ts.append(time.perf_counter() - t0)
    emit("e2e", leaf=leaf, impl="kernel", scene="dragon 512x512 d4 4spp",
         rays=int(rays), first_s=first, median_s=float(np.median(ts)),
         min_s=min(ts), mrays_s=rays / float(np.median(ts)) / 1e6)
    return tables, cam, band


def measure_grid(tables, band):
    import jax

    from vulkan_raytracer.accel.grid import build_grid
    from vulkan_raytracer.ops.grid_traverse import grid_closest, grid_shadow
    from vulkan_raytracer.ops.math3 import V3

    def cols(v):
        return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], -1)

    t0 = time.perf_counter()
    grid = build_grid(cols(tables.v0), cols(tables.v1), cols(tables.v2))
    emit("grid", build_s=time.perf_counter() - t0)

    def v3(a):
        return V3(a[:, 0], a[:, 1], a[:, 2])

    gc = jax.jit(lambda o, d, a, tmin: grid_closest(
        tables, grid, v3(o), v3(d), t_min=tmin, t_max=1e32, active=a)[0])
    gs = jax.jit(lambda o, d, t, a: grid_shadow(
        tables, grid, v3(o), v3(d), t_max=t, active=a)[0])
    for name, (o, d, act), tmin in (("primary", band["primary"], 1e-7),
                                    ("bounce", band["bounce"], 1e-4)):
        first, med, mn = timeit(gc, o, d, act, np.float32(tmin))
        emit("closest", leaf=None, wave=name, impl="grid_closest",
             first_s=first, median_s=med, min_s=mn)
    p, sd, dist, act = band["shadow"]
    first, med, mn = timeit(gs, p, sd, dist, act)
    emit("shadow", leaf=None, wave="shadow", impl="grid_shadow",
         first_s=first, median_s=med, min_s=mn)


def measure_xla_e2e(tables, cam):
    import jax

    from vulkan_raytracer.ops import bvh_kernel
    from vulkan_raytracer.render.renderer import render_image

    real = bvh_kernel.kernel_mode
    bvh_kernel.kernel_mode = lambda: None
    jax.clear_caches()
    try:
        t0 = time.perf_counter()
        _, rays = render_image(tables, cam, 512, 512, spp=4, max_depth=4,
                               tonemap=False)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, rays = render_image(tables, cam, 512, 512, spp=4, max_depth=4,
                               tonemap=False)
        warm = time.perf_counter() - t0
    finally:
        bvh_kernel.kernel_mode = real
        jax.clear_caches()
    emit("e2e", leaf=tables.bvh.leaf_size, impl="xla_trace_closest",
         scene="dragon 512x512 d4 4spp", rays=int(rays), first_s=first,
         median_s=warm, mrays_s=rays / warm / 1e6)


def measure_blocks(tables, band, leaf):
    for block, warps in ((32, 1), (64, 2), (128, 4), (256, 8)):
        w = _walkers(tables.bvh, block, warps)
        o, d, act = band["bounce"]
        first, med, mn = timeit(w["kernel_closest"], o, d, act, np.float32(1e-4))
        emit("block", leaf=leaf, wave="bounce", block=block, num_warps=warps,
             first_s=first, median_s=med, min_s=mn)


def measure_dense_crossover(leaf, sizes):
    import jax
    import jax.numpy as jnp

    from vulkan_raytracer.ops import bvh_kernel as bk
    from vulkan_raytracer.ops.dense import dense_closest, dense_shadow
    from vulkan_raytracer.ops.math3 import V3
    from vulkan_raytracer.scene.builtin import triangle_soup_scene

    n = 1 << 19
    r = np.random.default_rng(0)
    o = r.uniform(-12, 12, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = r.uniform(0.5, 8.0, n).astype(np.float32)
    ov = V3(*(jnp.asarray(o[:, k]) for k in range(3)))
    dv = V3(*(jnp.asarray(d[:, k]) for k in range(3)))
    act = jnp.ones((n,), bool)
    tm = jnp.asarray(tmax)
    from vulkan_raytracer.scene.builtin import cornell_box_scene

    for tris in sizes:
        if tris == "cornell":
            tables = cornell_box_scene().upload(leaf_size=leaf)
        else:
            tables = triangle_soup_scene(n_tris=tris, seed=1).upload(
                leaf_size=leaf)
        impls = dict(
            dense_closest=jax.jit(lambda o, d, a: dense_closest(
                tables, o, d, t_min=1e-7, t_max=1e32, active=a)),
            kernel_closest=jax.jit(lambda o, d, a: bk.kernel_closest(
                tables.bvh, o, d, t_min=1e-7, t_max=1e32, active=a)),
            dense_shadow=jax.jit(lambda o, d, a: dense_shadow(
                tables, o, d, t_max=tm, active=a)),
            kernel_shadow=jax.jit(lambda o, d, a: bk.kernel_shadow(
                tables.bvh, o, d, t_max=tm, active=a)),
        )
        for name, fn in impls.items():
            first, med, mn = timeit(fn, ov, dv, act, reps=3)
            emit("dense_crossover", tris=tables.num_triangles, scene=str(tris),
                 leaf=leaf, impl=name, lanes=n,
                 first_s=first, median_s=med, min_s=mn)


def reduce_trace(trace_dir, top=15):
    """Device-side kernels of a profiler trace: per GPU plane and line, the
    busiest event names with their summed device time."""
    from jax.profiler import ProfileData

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    out = []
    for path in paths:
        pd = ProfileData.from_file(path)
        for plane in pd.planes:
            if not plane.name.startswith("/device:GPU"):
                continue
            for line in plane.lines:
                tot = {}
                cnt = {}
                span = [None, None]
                for ev in line.events:
                    tot[ev.name] = tot.get(ev.name, 0.0) + ev.duration_ns
                    cnt[ev.name] = cnt.get(ev.name, 0) + 1
                    s, e = ev.start_ns, ev.start_ns + ev.duration_ns
                    span[0] = s if span[0] is None else min(span[0], s)
                    span[1] = e if span[1] is None else max(span[1], e)
                if not tot:
                    continue
                best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
                out.append(dict(
                    plane=plane.name, line=line.name, events=sum(cnt.values()),
                    distinct=len(tot), busy_ns=sum(tot.values()),
                    span_ns=(span[1] - span[0]),
                    top=[(k[:90], v, cnt[k]) for k, v in best]))
    return out


def measure_cornell_trace(trace_root):
    import jax
    import jax.numpy as jnp

    from vulkan_raytracer.ops.dense import dense_closest
    from vulkan_raytracer.render.integrator import generate_primary_rays
    from vulkan_raytracer.render.renderer import _render_one, camera_uniforms
    from vulkan_raytracer.scene.builtin import cornell_box_scene
    from vulkan_raytracer.scene.camera import Camera

    tables = cornell_box_scene().upload()
    cam = Camera(position=np.array([0.0, 1.0, 2.4]),
                 direction=np.array([0.0, 0.0, -1.0]), aspect=1.0)
    vi, pi = camera_uniforms(cam)
    o, d, _ = generate_primary_rays(vi, pi, 512, 512, jnp.uint32(1))
    act = jnp.ones((512 * 512,), bool)
    fold = jax.jit(lambda o, d, a: dense_closest(
        tables, o, d, t_min=1e-7, t_max=1e32, active=a))
    first, med, mn = timeit(fold, o, d, act)
    emit("cornell_fold", lanes=512 * 512, first_s=first, median_s=med, min_s=mn)
    hlo = fold.lower(o, d, act).compile().as_text()
    emit("cornell_fold_hlo", fusions=hlo.count(" fusion("),
         whiles=hlo.count(" while("), custom_calls=hlo.count("custom-call("))
    frame = lambda s: _render_one(tables, vi, pi, 512, 512, s, 4)  # noqa: E731
    jax.block_until_ready(frame(jnp.uint32(1)))
    for name, fn in (("cornell_fold_trace", lambda: fold(o, d, act)),
                     ("cornell_frame_trace", lambda: frame(jnp.uint32(2)))):
        tdir = os.path.join(trace_root, name)
        with jax.profiler.trace(tdir):
            for _ in range(3):
                jax.block_until_ready(fn())
        for rec in reduce_trace(tdir):
            emit(name, **rec)


def measure_cornell_e2e(reps=5):
    """Cornell 512x512 depth 4 64 spp end to end (the bench's cfg1 camera);
    VKRT_DENSE_MAX picks the dense fold or the BVH kernel."""
    from vulkan_raytracer.ops.dense import DENSE_MAX_TRIS
    from vulkan_raytracer.render.renderer import render_image
    from vulkan_raytracer.scene.builtin import cornell_box_scene
    from vulkan_raytracer.scene.camera import Camera

    tables = cornell_box_scene().upload()
    cam = Camera(position=np.array([0.0, 1.0, 2.4]),
                 direction=np.array([0.0, 0.0, -1.0]))

    def frame():
        return render_image(tables, cam, 512, 512, spp=64, max_depth=4,
                            as_uint8=True)

    t0 = time.perf_counter()
    _, rays = frame()
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _, rays = frame()
        ts.append(time.perf_counter() - t0)
    path = "dense" if tables.num_triangles <= DENSE_MAX_TRIS else "kernel"
    emit("cornell_e2e", path=path, dense_max=DENSE_MAX_TRIS,
         tris=tables.num_triangles, rays=int(rays), first_s=first,
         median_s=float(np.median(ts)), min_s=min(ts),
         mrays_s=rays / float(np.median(ts)) / 1e6)


def main() -> None:
    global _OUT, _CARD
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, "out", "traces"))
    ap.add_argument("--leaves", default="16,8,4",
                    help="leaf sizes to sweep (the first also gets the XLA "
                         "walk, grid, block sweep and crossover)")
    ap.add_argument("--crossover", default="1024,12288,65536",
                    help="soup sizes (or 'cornell') for the dense crossover")
    ap.add_argument("--cornell-e2e", action="store_true",
                    help="only the Cornell end-to-end frame timing")
    ap.add_argument("--no-reference", action="store_true",
                    help="skip the XLA-walk and grid timings and the traces")
    args = ap.parse_args()
    _OUT = args.out

    import jax

    from chip_smoke import card_info
    from vulkan_raytracer.utils.cache import setup_compile_cache

    if jax.devices()[0].platform != "gpu":
        sys.exit("measure_traversal: needs a GPU")
    setup_compile_cache()
    _CARD = card_info().splitlines()[0]
    emit("device", kind=jax.devices()[0].device_kind, jax=jax.__version__)
    if args.check:
        check()
        return
    if args.cornell_e2e:
        measure_cornell_e2e()
        return
    leaves = [int(x) for x in args.leaves.split(",")]
    ref = not args.no_reference
    first = None
    for leaf in leaves:
        tables, cam, band = measure_leaf(leaf, with_xla=ref and first is None)
        first = first or (tables, cam, band)
    tables, cam, band = first
    if ref:
        measure_grid(tables, band)
    measure_blocks(tables, band, leaves[0])
    if ref:
        measure_xla_e2e(tables, cam)
    sizes = [x if x == "cornell" else int(x) for x in args.crossover.split(",")]
    measure_dense_crossover(leaves[0], sizes)
    if ref:
        measure_cornell_trace(args.trace_dir)


if __name__ == "__main__":
    main()
