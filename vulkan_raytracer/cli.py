"""Command-line interface mirroring the reference's CLI surface.

Same flags and semantics as src/main.cpp:113-169: ``-r`` resolution,
``-b`` max ray depth, ``-m`` model list with per-model ``-t``/``-o``/``-s``
transform modifiers composed T*R*S (main.cpp:159-165), ``-c``/``-d`` camera
pose, ``--skybox``/``--skybox-strength``; comma-separated vector values with
the ``'d'`` default sentinel.  Headless additions (the reference renders
only to a swapchain): ``--spp``, ``--output``, ``--hdr-output``,
``--progressive``, ``--shard``, ``--trace``.

Default scene: the built-in procedural Cornell box (the reference defaults
to its bundled CornellBox.gltf, main.cpp:156).
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

import numpy as np

from .scene.builtin import cornell_box_scene, glass_sphere_scene, triangle_soup_scene
from .scene.procedural import chess_scene, dragon_scene, hall_scene
from .scene.camera import Camera
from .scene.gltf import quat_to_mat4
from .scene.scenegraph import Scene
from .utils import logging as log
from .utils.image import load_texture, write_png

DEFAULT_RESOLUTION = (800, 600)  # main.cpp:10
DEFAULT_DEPTH = 5  # main.cpp:124
DEFAULT_CAMERA_POS = (0.0, 1.0, 3.0)  # main.cpp:14
DEFAULT_CAMERA_DIR = (0.0, 0.0, -1.0)  # main.cpp:15
DEFAULT_SKYBOX = "hilly_terrain_01_4k.hdr"  # main.cpp:138

BUILTIN_SCENES = {
    "cornell": cornell_box_scene,
    "soup": triangle_soup_scene,
    "glass": glass_sphere_scene,
    "hall": hall_scene,  # Sponza-class (BASELINE config 4 stand-in)
    "dragon": dragon_scene,  # high-poly mesh (config 2 stand-in)
    "chess": chess_scene,  # transmission scene (config 3 stand-in)
}


def _parse_floats(value: str, n: int, name: str, default):
    if value == "d":
        return np.asarray(default, np.float64)
    parts = value.split(",")
    if len(parts) != n:
        raise argparse.ArgumentTypeError(
            f"{name} - must be 'd' or provide {n} comma-separated values"
        )
    try:
        return np.asarray([float(p) for p in parts], np.float64)
    except ValueError as e:
        raise argparse.ArgumentTypeError(f"{name} - could not parse '{value}': {e}")


def _parse_resolution(value: str):
    if value == "d":
        return DEFAULT_RESOLUTION
    parts = value.split(",")
    if len(parts) != 2:
        raise argparse.ArgumentTypeError(
            "resolution - must be 'd' or provide 2 positive integers"
        )
    w, h = int(parts[0]), int(parts[1])
    if w <= 0 or h <= 0:
        raise argparse.ArgumentTypeError("resolution must be positive")
    return w, h


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vkrt",
        description="A glTF path tracer (JAX/Pallas).",
    )
    p.add_argument("-r", "--resolution", type=_parse_resolution, default=DEFAULT_RESOLUTION,
                   help="Resolution w,h (default 800,600)")
    p.add_argument("-b", "--max-ray-depth", type=int, default=DEFAULT_DEPTH,
                   help="Max ray depth (default 5)")
    p.add_argument("-m", "--models", action="append", default=None,
                   help="glTF model file(s) or builtin scene names "
                        f"({', '.join(BUILTIN_SCENES)})")
    p.add_argument("-t", "--translations", action="append", default=None,
                   metavar="X,Y,Z", help="Model translation(s); 'd' = default")
    p.add_argument("-o", "--rotations", action="append", default=None,
                   metavar="W,X,Y,Z", help="Model rotation quaternion(s); 'd' = default")
    p.add_argument("-s", "--scales", action="append", default=None,
                   metavar="X,Y,Z", help="Model scale(s); 'd' = default")
    p.add_argument("-c", "--camera-position", default="d", metavar="X,Y,Z")
    p.add_argument("-d", "--camera-direction", default="d", metavar="X,Y,Z")
    # default-ON parity: args::ImplicitValueFlag yields the default name
    # even when the flag is absent, and it is consumed unconditionally
    # (main.cpp:138-139,167) — so absence means "try the bundled HDR",
    # resolved through the resource search path, warn-and-continue if the
    # asset is missing.  --no-skybox is our explicit off switch (the
    # reference has none; its off state is simply the asset not existing).
    p.add_argument("--skybox", nargs="?", const=DEFAULT_SKYBOX,
                   default=DEFAULT_SKYBOX,
                   help="Equirectangular HDR skybox file "
                        f"(default {DEFAULT_SKYBOX}, main.cpp:138)")
    p.add_argument("--no-skybox", action="store_true",
                   help="Disable the environment map")
    p.add_argument("--skybox-strength", type=float, default=1.0)
    # headless extensions (no swapchain on an accelerator host)
    p.add_argument("--spp", type=int, default=64, help="Samples per pixel")
    p.add_argument("--output", default="out.png", help="Output PNG path")
    p.add_argument("--hdr-output", default=None, help="Optional Radiance .hdr output")
    p.add_argument("--progressive", action="store_true",
                   help="Progressive per-frame loop (prints per-frame timing)")
    p.add_argument("--shard", action="store_true",
                   help="Shard pixels over all visible devices")
    p.add_argument("--interactive", action="store_true",
                   help="Terminal viewer with WASD/pan controls (needs a tty)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="Write a jax.profiler trace of the render to DIR "
                        "(the reference has only a wall-clock frame timer, "
                        "application.cpp:367)")
    p.add_argument("--checkpoint", default=None, metavar="NPZ",
                   help="Write the linear accumulation state after rendering "
                        "so a later run can --resume with more samples")
    p.add_argument("--resume", default=None, metavar="NPZ",
                   help="Continue accumulating on top of a --checkpoint "
                        "(same scene/camera/resolution/depth)")
    p.add_argument("--nee-weighting", choices=("reference", "physical"),
                   default="reference",
                   help="NEE estimator: 'reference' replicates the "
                        "reference's throughput quirk (raygen.rgen:54-83); "
                        "'physical' is the standard unbiased weighting")
    return p


def compose_transform(scale, rotation, translation) -> np.ndarray:
    """T * R * S composition (main.cpp:159-165)."""
    m = np.eye(4)
    if scale is not None:
        m = np.diag(list(scale) + [1.0]) @ m
    if rotation is not None:
        w, x, y, z = rotation
        m = quat_to_mat4(w, x, y, z).astype(np.float64) @ m
    if translation is not None:
        t = np.eye(4)
        t[:3, 3] = translation
        m = t @ m
    return m.astype(np.float32)


def load_scene(args) -> Scene:
    models = args.models or ["cornell"]
    if any(m in BUILTIN_SCENES for m in models):
        if len(models) > 1:
            raise SystemExit("builtin scenes cannot be composed with other models")
        scene = BUILTIN_SCENES[models[0]]()
    else:
        scene = Scene()
        for i, model in enumerate(models):
            transform = compose_transform(
                _get(args.scales, i, 3, "scale", (1.0, 1.0, 1.0)),
                _get(args.rotations, i, 4, "rotation", (1.0, 0.0, 0.0, 0.0)),
                _get(args.translations, i, 3, "translation", (0.0, 0.0, 0.0)),
            )
            scene.load_model(_resolve_model(model), transform)
    if args.skybox and not getattr(args, "no_skybox", False):
        sky_path = _resolve_model(args.skybox, optional=True)
        if sky_path is None:
            log.warn("skybox %s not found; rendering without environment", args.skybox)
        else:
            scene.skybox = load_texture(sky_path)[..., :3]
    scene.skybox_strength = args.skybox_strength
    return scene


def _get(lst, i, n, name, default):
    if lst is None or i >= len(lst):
        return np.asarray(default) if name != "rotation" else np.asarray(default)
    return _parse_floats(lst[i], n, name, default)


def _resolve_model(name: str, optional: bool = False):
    """Search as-given, then $VKRT_RESOURCE_DIR, then ./res (the analogue of
    the compile-time RESOURCE_DIR, CMakeLists.txt:56-61)."""
    candidates = [Path(name)]
    res = os.environ.get("VKRT_RESOURCE_DIR")
    if res:
        candidates.append(Path(res) / name)
    candidates.append(Path("res") / name)
    for c in candidates:
        if c.exists():
            return c
    if optional:
        return None
    raise FileNotFoundError(f"model not found: {name} (searched {candidates})")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    width, height = args.resolution

    from .utils.cache import setup_compile_cache

    setup_compile_cache()

    # debug mode: the analogue of the reference's Vulkan validation layers +
    # debugPrintf NaN guard in debug builds (application.h:91-104,
    # lightsample.glsl:169) — abort on the first NaN anywhere in the pipeline
    if os.environ.get("VKRT_DEBUG"):
        import jax

        jax.config.update("jax_debug_nans", True)
        log.info("VKRT_DEBUG: jax_debug_nans enabled")

    scene = load_scene(args)
    with log.Timer("scene upload + BVH build"):
        tables = scene.upload()

    cam_pos = _parse_floats(args.camera_position, 3, "camera-position", DEFAULT_CAMERA_POS)
    cam_dir = _parse_floats(args.camera_direction, 3, "camera-direction", DEFAULT_CAMERA_DIR)
    camera = Camera(position=cam_pos, direction=cam_dir, aspect=width / height)

    if args.interactive:
        from .viewer import run_viewer

        # full-resolution progressive loop (800x600 default, main.cpp:10);
        # the viewer decimates the display image to the terminal cell grid
        # on device, so the render size no longer needs a cap
        run_viewer(tables, camera, width, height, args.max_ray_depth)
        return 0

    if args.progressive:
        from .render.renderer import Renderer

        r = Renderer(tables, camera, width, height, args.max_ray_depth)
        for i in range(args.spp + 1):  # sample 0 is the preview frame
            t0 = time.perf_counter()
            img8 = r.draw_frame()
            log.info("frame %d (%.1f ms)", i, 1e3 * (time.perf_counter() - t0))
        write_png(args.output, img8)
        log.info("wrote %s after %d samples (%d rays)", args.output, args.spp, r.rays_traced)
        return 0

    profiler = None
    if args.trace:
        import jax

        jax.profiler.start_trace(args.trace)
        profiler = args.trace

    # checkpoint/resume: the accumulation buffer is the render's whole
    # state (raytracer.cpp:129-144); persisting the linear sum + sample
    # cursor lets long renders continue across runs — a headless capability
    # the reference's swapchain-only sink cannot offer.  A fingerprint of
    # (scene geometry, camera pose, resolution, depth, NEE estimator)
    # travels in the npz so --resume refuses to blend incompatible
    # accumulations instead of silently mixing them.
    fingerprint = _render_fingerprint(
        tables, camera, width, height, args.max_ray_depth, args.nee_weighting
    )
    acc_prev = None
    start_sample = 1
    if args.resume:
        ck = np.load(args.resume)
        if tuple(ck["shape"]) != (height, width) or int(ck["depth"]) != args.max_ray_depth:
            raise SystemExit("--resume checkpoint does not match this render")
        if "fingerprint" in ck and str(ck["fingerprint"]) != fingerprint:
            raise SystemExit(
                "--resume checkpoint was rendered with a different "
                "scene/camera/settings (fingerprint mismatch)"
            )
        acc_prev = ck["acc"].astype(np.float32)
        start_sample = int(ck["next_sample"])
        log.info("resuming at sample %d from %s", start_sample, args.resume)

    from .ops.tonemap import reinhard_jodie
    import jax.numpy as jnp

    t0 = time.perf_counter()
    if args.shard:
        # fleet entry point: single-process this is exactly the sharded
        # path over the local cards; under multi-host SPMD it broadcasts
        # host-0's scene and gathers bands cross-host
        # (parallel/multihost.py)
        from .parallel.multihost import (
            broadcast_scene_tables,
            make_fleet_mesh,
            render_image_multihost,
        )

        tables = broadcast_scene_tables(tables)
        mean_new, rays = render_image_multihost(
            tables, camera, width, height, args.spp, args.max_ray_depth,
            make_fleet_mesh(), start_sample=start_sample, tonemap=False,
            nee_weighting=args.nee_weighting,
        )
    else:
        from .render.renderer import render_image

        mean_new, rays = render_image(
            tables, camera, width, height, args.spp, args.max_ray_depth,
            start_sample=start_sample, tonemap=False,
            nee_weighting=args.nee_weighting,
        )
    # one linear accumulation feeds EVERY sink (checkpoint, PNG, HDR):
    # a single invocation cannot disagree with itself
    acc = np.asarray(mean_new, np.float32).reshape(height, width, 3) * np.float32(args.spp)
    if acc_prev is not None:
        acc = acc + acc_prev.reshape(acc.shape)
    total_spp = start_sample - 1 + args.spp
    if args.checkpoint:
        np.savez(args.checkpoint, acc=acc.astype(np.float32),
                 next_sample=np.int64(start_sample + args.spp),
                 shape=np.array([height, width]),
                 depth=np.int64(args.max_ray_depth),
                 fingerprint=np.str_(fingerprint))
        log.info("checkpoint -> %s (%d samples)", args.checkpoint, total_spp)
    mean = acc / np.float32(total_spp)
    img = np.asarray(reinhard_jodie(jnp.asarray(mean)))
    dt = time.perf_counter() - t0
    log.info(
        "rendered %dx%d @ %d spp depth %d in %.2fs - %.1f Mrays/s",
        width, height, args.spp, args.max_ray_depth, dt, rays / dt / 1e6,
    )
    if profiler:
        import jax

        jax.profiler.stop_trace()
        log.info("wrote profiler trace to %s", profiler)
    write_png(args.output, img.reshape(height, width, 3))
    log.info("wrote %s", args.output)
    if args.hdr_output:
        from .utils.image import write_hdr

        write_hdr(args.hdr_output, mean.reshape(height, width, 3))
        log.info("wrote %s (same accumulation as the PNG)", args.hdr_output)
    return 0


def _render_fingerprint(tables, camera, width, height, depth, nee) -> str:
    """Digest of everything that must match for accumulations to blend.

    Scene identity is fingerprinted by cheap geometry/material checksums
    (triangle count, coordinate sums, material count, emissive CDF tail,
    skybox shape/strength) rather than file names, so procedurally built
    and differently-pathed-but-identical scenes compare correctly.
    """
    import hashlib

    h = hashlib.sha256()
    h.update(np.asarray([width, height, depth], np.int64).tobytes())
    h.update(str(nee).encode())
    h.update(np.asarray(camera.position, np.float64).tobytes())
    h.update(np.asarray(camera.direction, np.float64).tobytes())
    h.update(np.float64(getattr(camera, "fov", 0.0)).tobytes())
    for col in (tables.v0.x, tables.v0.y, tables.v0.z, tables.v2.x):
        a = np.asarray(col)
        h.update(np.int64(a.shape[0]).tobytes())
        h.update(np.float64(a.sum(dtype=np.float64)).tobytes())
    h.update(np.int64(tables.materials.base_colour.x.shape[0]).tobytes())
    h.update(np.int64(tables.num_emissive_tris).tobytes())
    if tables.num_emissive_tris:
        h.update(np.float64(np.asarray(tables.em_cdf).sum(dtype=np.float64)).tobytes())
    h.update(np.asarray((tables.skybox.h, tables.skybox.w), np.int64).tobytes())
    h.update(np.float64(np.asarray(tables.skybox_strength)).tobytes())
    return h.hexdigest()


if __name__ == "__main__":
    sys.exit(main())
