#!/usr/bin/env python
"""End-to-end smoke of the renderer's main path on one NVIDIA GPU.

    python chip_smoke.py              # phases 1-5 on one card
    python chip_smoke.py --cards 4    # only the 4-card sharded render

Phases (one process; any failure exits nonzero and prints no result):

1. device: JAX must see a GPU (no CPU fallback); the card's name and power
   limit (``nvidia-smi``) and the acceleration-structure builder are
   printed.
2. the reference's own workload: the built-in Cornell box at 800x600,
   depth 5, through ``Renderer.draw_frame`` for a preview plus 8
   progressive frames.
3. a Cornell final frame at 512x512, depth 4, 64 spp through the CLI's
   ``main(argv)`` in this process, writing a PNG and an HDR; the radiance
   must be finite and not black.
4. the bench's dragon stand-in (262,280 triangles, 512x512, depth 4, 4 spp)
   through ``render_image``: the committed golden gate
   (``bench.quality_gate``) must pass, and the compiled render must contain
   the BVH kernel's Triton custom call.
5. the BVH kernel against its plain XLA reference walk on a 2^19-lane band
   of dragon rays (primary, first diffuse bounce, occlusion).

``--cards 4`` runs only ``render_image_sharded`` on the multi-model
stand-in at 1920x1080, depth 8, 8 spp over a 4-card mesh and compares it
with ``render_image`` on one card.

Every number goes on a line before the last, beside the card's name and
power limit.  The last stdout line is the JSON result object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "out", "chip_smoke")

#: phase 5 agreement bars (kernel vs reference walk, float32 throughout)
ID_AGREE_MIN = 0.9999
T_REL_TOL = 1e-5
OCC_AGREE_MIN = 0.9999

#: --cards 4 bar: per-pixel RMSE of the sharded vs the one-card render
SHARD_RMSE_MAX = 1e-4


def result_line(platform: str, kind: str, count: int) -> str:
    """The final stdout line."""
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind, "count": count}}
    )


def card_info() -> str:
    """``name, power limit`` of each card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


class Smoke:
    def __init__(self, card: str):
        self.card = card.splitlines()[0]

    def say(self, msg: str) -> None:
        print(f"[{self.card}] {msg}", flush=True)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_cornell_progressive(sm: Smoke) -> None:
    import numpy as np

    from vulkan_raytracer.render.renderer import Renderer
    from vulkan_raytracer.scene.builtin import cornell_box_scene
    from vulkan_raytracer.scene.camera import Camera

    tables = cornell_box_scene().upload()
    cam = Camera(position=np.array([0.0, 1.0, 3.0]),
                 direction=np.array([0.0, 0.0, -1.0]))
    r = Renderer(tables, cam, 800, 600, max_depth=5)
    times = []
    for _ in range(9):  # the preview frame + 8 accumulated frames
        img, dt = _timed(r.draw_frame)
        times.append(dt)
    accum = np.asarray(r.accum)
    assert img.shape == (600, 800, 3), img.shape
    assert np.isfinite(accum).all(), "non-finite accumulation"
    assert img.max() > 0, "black frame"
    assert r.sample_count == 9
    sm.say(
        f"phase 2 cornell progressive 800x600 d5: first frame {times[0]:.3f} s "
        f"(compile included), frames 2-9 median {np.median(times[1:]):.4f} s, "
        f"{r.rays_traced} rays over 9 frames"
    )


def phase_cornell_cli(sm: Smoke) -> None:
    import numpy as np

    from vulkan_raytracer.cli import main as cli_main
    from vulkan_raytracer.utils.image import read_hdr

    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, "cornell_512.png")
    hdr = os.path.join(OUT_DIR, "cornell_512.hdr")
    argv = ["-m", "cornell", "-r", "512,512", "-b", "4", "--spp", "64",
            "-c", "0,1,2.4", "-d", "0,0,-1", "--no-skybox",
            "--output", png, "--hdr-output", hdr]
    rc, cold = _timed(lambda: cli_main(argv))
    assert rc == 0, rc
    rc, warm = _timed(lambda: cli_main(argv))
    assert rc == 0, rc
    rad = read_hdr(hdr)
    assert rad.shape[:2] == (512, 512), rad.shape
    assert np.isfinite(rad).all(), "non-finite radiance"
    assert rad.mean() > 1e-3, f"black frame (mean {rad.mean()})"
    assert os.path.getsize(png) > 0
    sm.say(
        f"phase 3 cornell CLI 512x512 d4 64spp: cold {cold:.3f} s, warm "
        f"{warm:.3f} s, mean radiance {rad.mean():.5f}"
    )


def phase_dragon(sm: Smoke):
    import jax.numpy as jnp
    import numpy as np

    import bench
    from vulkan_raytracer.ops.bvh_kernel import KERNEL_NAME
    from vulkan_raytracer.render.renderer import (
        _render_batch,
        camera_uniforms,
        render_image,
    )

    cfg = next(c for c in bench.CONFIGS if c["key"].startswith("cfg2_dragon"))
    (tables, _), build_s = _timed(bench._dragon)
    assert tables.num_triangles == 262280, tables.num_triangles
    cam = bench._cam(*cfg["cam"])
    goldens = np.load(bench.GOLDENS, allow_pickle=False)
    rmse, gate_s = _timed(
        lambda: bench.quality_gate(cfg["key"], tables, cam, cfg["crop"], goldens))
    w, h, spp, depth = cfg["w"], cfg["h"], cfg["spp"], cfg["depth"]

    def render():
        return render_image(tables, cam, w, h, spp=spp, max_depth=depth,
                            tonemap=False)

    (img, rays), cold = _timed(render)
    (img, rays), warm = _timed(render)
    assert np.isfinite(img).all() and img.mean() > 1e-3, img.mean()

    # the compiled render runs the Pallas kernel through Triton, not a
    # plain fallback
    cam.aspect = w / h
    vi, pi = camera_uniforms(cam)
    lowered = _render_batch.lower(tables, vi, pi, w, h, depth, spp,
                                  jnp.uint32(1), nee_weighting="reference")
    hlo = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in hlo and KERNEL_NAME in hlo, \
        "BVH kernel missing from the lowered render"
    compiled = lowered.compile().as_text()
    assert "__gpu$xla.gpu.triton" in compiled, \
        "BVH kernel missing from the compiled render"
    sm.say(
        f"phase 4 dragon 262280 tris {w}x{h} d{depth} {spp}spp: scene build "
        f"{build_s:.2f} s, golden gate RMSE {rmse:.3e} (bar 2e-3, "
        f"{gate_s:.2f} s incl. compile), render cold {cold:.3f} s, warm "
        f"{warm:.3f} s, {rays} rays = {rays / warm / 1e6:.2f} Mrays/s warm; "
        f"Triton kernel {KERNEL_NAME} present in compiled render"
    )
    return tables, cam


def dragon_band(tables, cam, n_lanes=1 << 19, seed=0):
    """A band of dragon rays: jittered primaries over the 512x512 frame,
    their first hits, a cosine-free uniform bounce from each hit, and an
    occlusion segment from each hit toward the ceiling light."""
    import jax
    import jax.numpy as jnp

    from vulkan_raytracer.ops.traverse import trace_closest
    from vulkan_raytracer.render.integrator import generate_primary_rays
    from vulkan_raytracer.render.renderer import camera_uniforms

    w = h = 512
    cam.aspect = 1.0
    vi, pi = camera_uniforms(cam)
    lanes = jnp.arange(n_lanes, dtype=jnp.uint32) % jnp.uint32(w * h)
    samples = 1 + jnp.arange(n_lanes, dtype=jnp.uint32) // jnp.uint32(w * h)
    o, d, _ = jax.jit(
        lambda vi, pi, lanes, s: generate_primary_rays(vi, pi, w, h, s, lanes)
    )(vi, pi, lanes, samples)
    o, d = o.to_array(), d.to_array()
    act = jnp.ones((n_lanes,), bool)
    (t, tri, _, _), _ = jax.jit(
        lambda o, d: trace_closest(tables.bvh, o, d, t_min=1e-7, t_max=1e32,
                                   active=act))(o, d)
    hit = tri >= 0
    p = o + d * jnp.where(hit, t, 0.0)[:, None]
    key = jax.random.PRNGKey(seed)
    k1, k2 = jax.random.split(key)
    nd = jax.random.normal(k1, (n_lanes, 3), jnp.float32)
    nd = nd / jnp.linalg.norm(nd, axis=1, keepdims=True)
    light = jnp.asarray([0.0, 4.0, 0.0]) + jax.random.uniform(
        k2, (n_lanes, 3), jnp.float32, -1.5, 1.5) * jnp.asarray([1.0, 0.0, 1.0])
    sd = light - p
    dist = jnp.linalg.norm(sd, axis=1)
    sd = sd / dist[:, None]
    return dict(primary=(o, d, act), bounce=(p, nd, hit),
                shadow=(p, sd, dist, hit))


def compare_closest(bvh, o, d, act, t_min):
    """Kernel vs reference closest hit; returns (agree, n_live, n_bad_t,
    n_bad_tie, seconds kernel, seconds reference)."""
    import jax
    import numpy as np

    from vulkan_raytracer.ops.bvh_kernel import kernel_closest
    from vulkan_raytracer.ops.traverse import trace_closest

    k = jax.jit(lambda o, d, a: kernel_closest(
        bvh, o, d, t_min=t_min, t_max=1e32, active=a))
    r = jax.jit(lambda o, d, a: trace_closest(
        bvh, o, d, t_min=t_min, t_max=1e32, active=a)[0])
    jax.block_until_ready(k(o, d, act))
    jax.block_until_ready(r(o, d, act))
    (tk, ik, _, _), sk = _timed(lambda: jax.block_until_ready(k(o, d, act)))
    (tr, ir, _, _), sr = _timed(lambda: jax.block_until_ready(r(o, d, act)))
    tk, ik, tr, ir, live = (np.asarray(x) for x in (tk, ik, tr, ir, act))
    same = ik == ir
    agree = same[live].mean()
    both = same & live & (ir >= 0)
    bad_t = np.sum(np.abs(tk[both] - tr[both]) > T_REL_TOL * tr[both])
    diff = live & ~same
    with np.errstate(invalid="ignore"):
        tie = np.abs(tk[diff] - tr[diff]) <= T_REL_TOL * np.minimum(tk[diff], tr[diff])
    return agree, int(live.sum()), int(bad_t), int((~tie).sum()), sk, sr


def phase_kernel_vs_reference(sm: Smoke, tables, cam) -> None:
    import jax
    import numpy as np

    from vulkan_raytracer.ops.bvh_kernel import kernel_shadow
    from vulkan_raytracer.ops.traverse import trace_shadow

    band = dragon_band(tables, cam)
    bvh = tables.bvh
    n = band["primary"][2].shape[0]
    for name, (o, d, act), t_min in (
        ("primary", band["primary"], 1e-7),
        ("bounce", band["bounce"], 1e-4),
    ):
        agree, live, bad_t, bad_tie, sk, sr = compare_closest(bvh, o, d, act, t_min)
        sm.say(
            f"phase 5 {name} closest, {n} lanes ({live} live): ids agree "
            f"{agree:.6f} (bar {ID_AGREE_MIN}), |dt|>1e-5 t on agreeing "
            f"hits {bad_t}, non-tie disagreements {bad_tie}; kernel "
            f"{sk * 1e3:.3f} ms, XLA trace_closest {sr * 1e3:.3f} ms"
        )
        assert agree >= ID_AGREE_MIN, (name, agree)
        assert bad_t == 0, (name, bad_t)
        assert bad_tie == 0, (name, bad_tie)

    p, sd, dist, act = band["shadow"]
    k = jax.jit(lambda o, d, t, a: kernel_shadow(bvh, o, d, t_max=t, active=a))
    r = jax.jit(lambda o, d, t, a: trace_shadow(bvh, o, d, t_max=t, active=a)[0])
    jax.block_until_ready(k(p, sd, dist, act))
    jax.block_until_ready(r(p, sd, dist, act))
    ok, sk = _timed(lambda: jax.block_until_ready(k(p, sd, dist, act)))
    orf, sr = _timed(lambda: jax.block_until_ready(r(p, sd, dist, act)))
    ok, orf = np.asarray(ok), np.asarray(orf)
    agree = (ok == orf).mean()
    sm.say(
        f"phase 5 occlusion, {n} lanes: flags agree {agree:.6f} (bar "
        f"{OCC_AGREE_MIN}), occluded share {orf.mean():.4f}; kernel "
        f"{sk * 1e3:.3f} ms, XLA trace_shadow {sr * 1e3:.3f} ms"
    )
    assert agree >= OCC_AGREE_MIN, agree


def phase_sharded(sm: Smoke, n_cards: int, w=1920, h=1080, spp=8,
                  depth=8) -> None:
    import jax
    import numpy as np

    import bench
    from vulkan_raytracer.parallel.sharding import make_mesh, render_image_sharded
    from vulkan_raytracer.render.renderer import render_image

    cfg = next(c for c in bench.CONFIGS if c["key"].startswith("cfg5_multi"))
    tables, _ = bench._multi()
    cam = bench._cam(*cfg["cam"])
    mesh = make_mesh(jax.devices()[:n_cards])

    def sharded():
        return render_image_sharded(tables, cam, w, h, spp=spp, max_depth=depth,
                                    mesh=mesh, tonemap=False)

    (img_s, rays_s), cold_s = _timed(sharded)
    (img_s, rays_s), warm_s = _timed(sharded)
    for dev in jax.devices()[:n_cards]:
        st = dev.memory_stats() or {}
        sm.say(
            f"cards={n_cards} {dev}: bytes in use "
            f"{st.get('bytes_in_use', 'n/a')}, peak "
            f"{st.get('peak_bytes_in_use', 'n/a')}"
        )

    def single():
        return render_image(tables, cam, w, h, spp=spp, max_depth=depth,
                            tonemap=False)

    (img_1, rays_1), cold_1 = _timed(single)
    (img_1, rays_1), warm_1 = _timed(single)
    img_s, img_1 = np.asarray(img_s), np.asarray(img_1)
    rmse = float(np.sqrt(np.mean((img_s - img_1) ** 2)))
    sm.say(
        f"cards={n_cards} multi-model {w}x{h} d{depth} {spp}spp "
        f"({tables.num_triangles} tris): sharded cold {cold_s:.3f} s warm "
        f"{warm_s:.3f} s; one card cold {cold_1:.3f} s warm {warm_1:.3f} s; "
        f"rays sharded {rays_s} vs one card {rays_1}; per-pixel RMSE "
        f"{rmse:.3e} (bar {SHARD_RMSE_MAX}), max |diff| "
        f"{np.abs(img_s - img_1).max():.3e}"
    )
    assert np.isfinite(img_s).all() and img_s.mean() > 1e-3
    assert rays_s == rays_1, (rays_s, rays_1)
    assert rmse < SHARD_RMSE_MAX, rmse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded render over four cards")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    os.environ.setdefault("VKRT_LOG_LEVEL", "ERROR")
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        print(f"chip_smoke: no GPU visible to JAX (platform {platform!r})",
              file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} but JAX sees {len(devices)}",
              file=sys.stderr)
        return 2

    from vulkan_raytracer.accel.native import get_lib
    from vulkan_raytracer.utils.cache import setup_compile_cache

    cache_dir = setup_compile_cache()
    card = card_info()
    print(f"card (nvidia-smi name, power.limit): {card}", flush=True)
    sm = Smoke(card)
    builder = "native" if get_lib() is not None else "NumPy"
    sm.say(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}, "
           f"compile cache {cache_dir}, acceleration-structure builder: {builder}")

    if args.cards == 4:
        _, dt = _timed(lambda: phase_sharded(sm, 4))
        sm.say(f"sharded phase {dt:.1f} s")
    else:
        for name, fn in (("2", phase_cornell_progressive),
                         ("3", phase_cornell_cli)):
            _, dt = _timed(lambda: fn(sm))
            sm.say(f"phase {name} {dt:.1f} s")
        (tables, cam), dt = _timed(lambda: phase_dragon(sm))
        sm.say(f"phase 4 {dt:.1f} s")
        _, dt = _timed(lambda: phase_kernel_vs_reference(sm, tables, cam))
        sm.say(f"phase 5 {dt:.1f} s")

    print(result_line(platform, devices[0].device_kind, len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
