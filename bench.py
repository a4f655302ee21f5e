#!/usr/bin/env python
"""Benchmark: the five BASELINE.md configs, one JSON line each.

Each line: {"metric", "value", "unit", ...extras}.
value = Mrays/s on the current accelerator (real traversals counted
in-program: material + NEE shadow/verify + MIS pdf-probe rays).  The
reference publishes no numbers of its own (BASELINE.md).

Configs (BASELINE.json `configs`; gallery assets are not redistributable so
2/3/4/5 use workload-equivalent procedural stand-ins from
vulkan_raytracer.scene.procedural - stated in each metric name):
  1. res/CornellBox.gltf (the reference's bundled asset, loaded through the
     real glTF importer) at 512x512, depth 4, 64 spp.  <- headline, printed
     LAST so the driver's tail-parse picks it up.
  2. dragon-class: 262k-tri displaced-sphere mesh, 512x512, depth 4.
  3. chess-class: 98k tris glass/rough-transmission set, 512x512, depth 6.
  4. sponza-class: 256k-tri colonnade hall + procedural HDR skybox
     (emissive NEE + MIS), 960x540, depth 4, 8 spp.
  5. multi-model composed scene at 1920x1080, depth 8, 8 spp.

cfg4/cfg5 run at spp 8 so the banded renderer batches spp_chunk=8
samples per wave; the spp is in the metric name.  Their warm-up renders
ONE band (same compiled executable as all bands) instead of a full frame.

EVERY config's timed reps are spread across the whole run — cfg1 takes 3
up front and 1 after every other batch, and the other configs' remaining
reps run round-robin after their first — so one degraded window (host
contention) cannot depress every rep of any config.  Each line publishes
min + median + the rep spread.  ALL result lines print together at the
end, so a bounded tail capture either holds every config or none.

Quality gates: every config's small-crop render is compared against a
COMMITTED oracle golden (bench_goldens.npz, regenerated by
tools/gen_bench_goldens.py); golden staleness is caught by a
scene/camera fingerprint stored alongside each crop.

Budgeting: a global soft deadline (VKRT_BENCH_BUDGET seconds, default
2200) trims best-of-N reps - never configs or gates - so all five lines
always print.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

os.environ.setdefault("VKRT_LOG_LEVEL", "ERROR")

import numpy as np  # noqa: E402

from vulkan_raytracer.utils.cache import setup_compile_cache  # noqa: E402

setup_compile_cache()

REFERENCE_CORNELL = "/root/reference/res/CornellBox.gltf"
GOLDENS = os.path.join(ROOT, "bench_goldens.npz")
BUDGET = float(os.environ.get("VKRT_BENCH_BUDGET", "2200"))
_T0 = time.monotonic()


def _elapsed() -> float:
    return time.monotonic() - _T0


def _mark(msg: str) -> None:
    """Phase timing to stderr (diagnostics only; stdout stays one JSON
    line per config for the driver's tail-parse)."""
    print(f"[bench +{_elapsed():7.1f}s] {msg}", file=sys.stderr, flush=True)


def _cam(pos, d):
    from vulkan_raytracer.scene.camera import Camera

    return Camera(position=np.array(pos, np.float64),
                  direction=np.array(d, np.float64))


def _cornell():
    """The reference's own bundled asset through the real importer; falls
    back to the procedural builtin if the reference checkout is absent."""
    from vulkan_raytracer.scene.builtin import cornell_box_scene
    from vulkan_raytracer.scene.scenegraph import Scene

    if os.path.exists(REFERENCE_CORNELL):
        s = Scene()
        s.load_model(REFERENCE_CORNELL)
        return s.upload(), "refgltf"
    return cornell_box_scene().upload(), "builtin"


def _dragon():
    from vulkan_raytracer.scene.procedural import dragon_scene

    return dragon_scene().upload(), None


def _chess():
    from vulkan_raytracer.scene.procedural import chess_scene

    return chess_scene().upload(), None


def _hall_sky():
    from vulkan_raytracer.scene.procedural import hall_scene, sky_hdr

    s = hall_scene()
    s.skybox = sky_hdr()
    s.skybox_strength = 1.0
    return s.upload(), None


def _multi():
    from vulkan_raytracer.scene.procedural import multi_scene

    return multi_scene().upload(), None


# (key, build, cam, w, h, spp, depth, crop=(cw, cspp, cdepth), reps)
# Execution order: 2..5 first, headline cfg1 LAST (driver tail-parse).
CONFIGS = [
    dict(key="cfg2_dragon_substitute_262k_512x512_d4", build=_dragon,
         cam=([0.0, 2.2, 4.5], [0.0, -0.25, -1.0]),
         w=512, h=512, spp=4, depth=4, crop=(16, 2, 3), reps=3,
         warm="band"),
    dict(key="cfg3_chess_substitute_98k_512x512_d6", build=_chess,
         cam=([0.0, 4.0, 7.0], [0.0, -0.5, -1.0]),
         w=512, h=512, spp=4, depth=6, crop=(16, 2, 4), reps=3,
         warm="band"),
    dict(key="cfg4_sponza_substitute_256k_hdrsky_960x540_d4_8spp",
         build=_hall_sky,
         cam=([-9.0, 1.8, 0.0], [1.0, 0.0, 0.0]),
         w=960, h=540, spp=8, depth=4, crop=(16, 2, 3), reps=3,
         warm="band"),
    dict(key="cfg5_multimodel_1920x1080_d8_8spp", build=_multi,
         cam=([-9.0, 2.0, 1.5], [1.0, -0.1, -0.15]),
         w=1920, h=1080, spp=8, depth=8, crop=(12, 1, 4), reps=2,
         warm="band"),
    dict(key="cfg1_cornell_{src}_512x512_d4_64spp", build=_cornell,
         cam=([0.0, 1.0, 2.4], [0.0, 0.0, -1.0]),
         w=512, h=512, spp=64, depth=4, crop=(48, 4, 3), reps=9),
]


def gate_fingerprint(tables, cam, cw, cspp, cdepth) -> str:
    """Scene+camera+crop digest that must match the stored golden's."""
    from vulkan_raytracer.cli import _render_fingerprint

    return _render_fingerprint(tables, cam, cw, cw, cdepth, True) + f":{cspp}"


def quality_gate(key, tables, cam, crop, goldens, bar=2e-3):
    """Small-crop per-pixel RMSE vs the COMMITTED oracle golden.

    Runs through the SAME traversal dispatch as the timed config (big
    scenes exercise the BVH walk on the card), so every published number
    is tied to a correctness bound without paying an in-bench brute-force
    oracle render.
    """
    from vulkan_raytracer.render.renderer import render_image

    cw, cspp, cdepth = crop
    gkey, fkey = f"golden_{key}", f"fp_{key}"
    if gkey not in goldens:
        raise SystemExit(
            f"{key}: no committed golden - run tools/gen_bench_goldens.py")
    fp = gate_fingerprint(tables, cam, cw, cspp, cdepth)
    if str(goldens[fkey]) != fp:
        raise SystemExit(
            f"{key}: golden fingerprint stale ({goldens[fkey]} != {fp}) - "
            "scene/camera/gate changed; rerun tools/gen_bench_goldens.py")
    img_x, _ = render_image(tables, cam, cw, cw, spp=cspp, max_depth=cdepth,
                            tonemap=False)
    rmse = float(np.sqrt(np.mean((np.asarray(img_x) - goldens[gkey]) ** 2)))
    assert rmse < bar, f"{key}: RMSE {rmse} vs oracle golden exceeds {bar}"
    return rmse


def _warm_one_band(tables, cam, w, h, spp, depth) -> None:
    """Compile warm-up for banded configs: render ONE band (uniform band
    shapes -> the same executable every band uses) instead of the whole
    frame."""
    import jax
    import jax.numpy as jnp

    from vulkan_raytracer.render.integrator import _block_order
    from vulkan_raytracer.render.renderer import (
        MAX_LANES_PER_PASS,
        _postprocess,
        _render_band,
        camera_uniforms,
        default_spp_chunk,
    )

    cam.aspect = w / h
    vi, pi = camera_uniforms(cam)
    n = w * h
    chunk = default_spp_chunk(spp)
    n_bands = -(-n * chunk // MAX_LANES_PER_PASS)
    per = -(-n // n_bands)
    order, _ = _block_order(w, h)
    lanes = jnp.asarray(order[:per])
    a, _ = _render_band(tables, vi, pi, w, h, depth, min(chunk, spp),
                        jnp.uint32(1), lanes)
    jax.block_until_ready(_postprocess(a, spp, False, True))


class _Cfg:
    """One prepared config: built scene, gate passed, compiles warm."""

    def __init__(self, cfg, goldens):
        from vulkan_raytracer.render.renderer import render_image

        self._render_image = render_image
        self.cfg = cfg
        _mark(f"{cfg['key']}: build+gate+warmup")
        self.tables, src = cfg["build"]()
        self.key = (cfg["key"].format(src=src) if "{src}" in cfg["key"]
                    else cfg["key"])
        self.cam = _cam(*cfg["cam"])
        cw, cspp, _ = cfg["crop"]
        self.rmse = quality_gate(cfg["key"], self.tables, self.cam,
                                 cfg["crop"], goldens)
        self.rmse_key = f"rmse_vs_oracle_{cw}x{cw}_{cspp}spp"
        w, h, spp, depth = cfg["w"], cfg["h"], cfg["spp"], cfg["depth"]
        if cfg.get("warm") == "band":
            _warm_one_band(self.tables, self.cam, w, h, spp, depth)
        else:
            img, _ = render_image(self.tables, self.cam, w, h, spp=spp,
                                  max_depth=depth, as_uint8=True)
            assert img.any(), f"{self.key}: all-black warmup"
        self.times = []
        self.rays = 0

    def rep(self, n=1) -> None:
        cfg = self.cfg
        for i in range(n):
            if self.times and _elapsed() + min(self.times) > BUDGET:
                return  # soft deadline trims reps, never configs/gates
            t0 = time.perf_counter()
            img, rays = self._render_image(
                self.tables, self.cam, cfg["w"], cfg["h"], spp=cfg["spp"],
                max_depth=cfg["depth"], as_uint8=True)
            self.times.append(time.perf_counter() - t0)
            assert img.any(), f"{self.key}: all-black render"
            self.rays = rays

    def line(self) -> dict:
        cfg = self.cfg
        dt = min(self.times)
        mrays = self.rays / dt / 1e6
        line = {
            "metric": f"Mrays_{self.key}",
            "value": round(mrays, 3),
            "unit": "Mrays/s",
            "spp": cfg["spp"],
            "depth": cfg["depth"],
            "resolution": f"{cfg['w']}x{cfg['h']}",
            self.rmse_key: round(self.rmse, 9),
        }
        if len(self.times) > 1:
            med = float(np.median(self.times))
            line["median_mrays"] = round(self.rays / med / 1e6, 3)
            line["reps"] = len(self.times)
            line["rep_s"] = [round(t, 2) for t in
                             (min(self.times), med, max(self.times))]
        return line


def main() -> None:
    goldens = np.load(GOLDENS, allow_pickle=False)
    summary = {"metric": "bench_summary", "unit": "Mrays/s"}

    # cfg1 first: its reps are spread over the whole run so a degraded
    # window (host contention) can't depress every sample (its line still
    # prints LAST)
    c1 = _Cfg(CONFIGS[-1], goldens)
    c1.rep(3)

    others = []
    for cfg in CONFIGS[:-1]:
        c = _Cfg(cfg, goldens)
        _mark(f"{c.key}: first timed rep")
        c.rep(1)
        others.append(c)
        c1.rep(1)

    # round-robin the remaining reps so a degraded window covers at most
    # one rep of each config and every published min/median reflects
    # samples taken minutes apart
    extra_passes = max(cfg["reps"] for cfg in CONFIGS[:-1]) - 1
    for p in range(extra_passes):
        _mark(f"round-robin rep pass {p + 2}")
        for c in others:
            if len(c.times) < c.cfg["reps"]:
                c.rep(1)
        c1.rep(1)

    _mark("cfg1: final reps")
    c1.rep(max(CONFIGS[-1]["reps"] - len(c1.times), 0))

    # ALL result lines print together at the end: a bounded tail capture
    # either holds every config or none
    for c in others:
        line = c.line()
        print(json.dumps(line), flush=True)
        summary[c.key] = line["value"]
    line = c1.line()
    summary[c1.key] = line["value"]
    summary["cfg1_median"] = line.get("median_mrays", line["value"])
    summary["wall_s"] = round(_elapsed(), 1)
    # the summary precedes the headline so a bounded tail capture always
    # holds every config's value even if earlier lines scrolled out
    print(json.dumps(summary), flush=True)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
