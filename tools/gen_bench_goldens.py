#!/usr/bin/env python
"""Regenerate bench_goldens.npz: oracle crops for every bench config gate.

Run OFFLINE (CPU, minutes) whenever a bench scene/camera/gate changes; the
resulting npz is committed so bench.py never pays a brute-force oracle
render on the clock.  Each crop is stored with a
scene/camera fingerprint so staleness is a hard error, not silent drift.

Usage: python tools/gen_bench_goldens.py [cfg_key ...]
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("VKRT_LOG_LEVEL", "ERROR")

import numpy as np  # noqa: E402

import bench  # noqa: E402
from vulkan_raytracer.render import oracle  # noqa: E402


def main() -> None:
    only = set(sys.argv[1:])
    out = {}
    if os.path.exists(bench.GOLDENS):
        prev = np.load(bench.GOLDENS, allow_pickle=False)
        out.update({k: prev[k] for k in prev.files})
    for cfg in bench.CONFIGS:
        key = cfg["key"]
        if only and key not in only:
            continue
        t0 = time.time()
        tables, _ = cfg["build"]()
        cam = bench._cam(*cfg["cam"])
        cw, cspp, cdepth = cfg["crop"]
        img = oracle.render_image(tables, cam, cw, cw, spp=cspp,
                                  max_depth=cdepth)
        out[f"golden_{key}"] = np.asarray(img, np.float32)
        out[f"fp_{key}"] = np.str_(
            bench.gate_fingerprint(tables, cam, cw, cspp, cdepth))
        np.savez_compressed(bench.GOLDENS, **out)  # incremental: survive kills
        print(f"{key}: {cw}x{cw} {cspp}spp d{cdepth} oracle crop in "
              f"{time.time() - t0:.1f}s", flush=True)
    print(f"wrote {bench.GOLDENS} ({os.path.getsize(bench.GOLDENS)} bytes)")


if __name__ == "__main__":
    main()
