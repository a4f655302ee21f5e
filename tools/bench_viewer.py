#!/usr/bin/env python
"""Interactive frame-loop timing at the reference's 800x600 (main.cpp:10).

Measures the full per-frame path off-tty: fused render+accumulate+
tonemap+uint8+decimate device step (ONE dispatch), host fetch of the
terminal-sized display image, and the ANSI presenter string build.
The reference's progressive loop runs 800x600 in a window
(application.cpp:346-408).  Usage: python tools/bench_viewer.py [w h depth]
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("VKRT_LOG_LEVEL", "ERROR")

import numpy as np  # noqa: E402

from vulkan_raytracer.utils.cache import setup_compile_cache  # noqa: E402

setup_compile_cache()


def main():
    w = int(sys.argv[1]) if len(sys.argv) > 1 else 800
    h = int(sys.argv[2]) if len(sys.argv) > 2 else 600
    depth = int(sys.argv[3]) if len(sys.argv) > 3 else 5

    from vulkan_raytracer.render.renderer import Renderer
    from vulkan_raytracer.scene.builtin import cornell_box_scene
    from vulkan_raytracer.scene.camera import Camera
    from vulkan_raytracer.viewer import _present, display_size

    tables = cornell_box_scene().upload()
    cam = Camera(position=np.array([0.0, 1.0, 3.0]),
                 direction=np.array([0.0, 0.0, -1.0]))
    r = Renderer(tables, cam, w, h, max_depth=depth)

    class T:  # a 100x32 terminal (common tmux pane)
        columns, lines = 100, 32

    disp = display_size(w, h, term=T)
    img = r.draw_frame(display_size=disp)  # compile
    n = 30
    t_total = t_present = 0.0
    t0 = time.perf_counter()
    for _ in range(n):
        img = r.draw_frame(display_size=disp)
        tp = time.perf_counter()
        s = _present(img)
        t_present += time.perf_counter() - tp
    t_total = time.perf_counter() - t0
    fps = n / t_total
    print(
        f"{w}x{h} depth {depth} progressive cornell: {fps:6.2f} fps "
        f"({1e3 * t_total / n:.1f} ms/frame, present {1e3 * t_present / n:.1f} ms, "
        f"display {disp[1]}x{disp[0]} cells, {r.rays_traced / t_total / 1e6:.1f} Mrays/s)",
        flush=True,
    )




def main_pipelined():
    """Same loop with swapchain-latency pipelining (fetch N-1 while N runs)."""
    w, h, depth = 800, 600, 5
    from vulkan_raytracer.render.renderer import Renderer
    from vulkan_raytracer.scene.builtin import cornell_box_scene
    from vulkan_raytracer.scene.camera import Camera
    from vulkan_raytracer.viewer import _present, display_size

    tables = cornell_box_scene().upload()
    cam = Camera(position=np.array([0.0, 1.0, 3.0]),
                 direction=np.array([0.0, 0.0, -1.0]))
    r = Renderer(tables, cam, w, h, max_depth=depth)

    class T:
        columns, lines = 100, 32

    disp = display_size(w, h, term=T)
    r.draw_frame(display_size=disp, pipeline=True)  # compile + prime
    n = 30
    t0 = time.perf_counter()
    shown = 0
    for _ in range(n):
        img = r.draw_frame(display_size=disp, pipeline=True)
        if img is not None:
            _present(img)
            shown += 1
    t_total = time.perf_counter() - t0
    print(f"{w}x{h} depth {depth} PIPELINED: {n / t_total:6.2f} fps "
          f"({1e3 * t_total / n:.1f} ms/frame, {shown} presented)", flush=True)


if __name__ == "__main__":
    if "pipelined" in sys.argv:
        main_pipelined()
    else:
        main()
