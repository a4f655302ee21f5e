"""A REAL two-process fleet over localhost DCN (Gloo collectives).

tests/test_multihost.py pins the single-process contracts; this test
forms an actual ``jax.distributed`` fleet — two processes x 4 virtual
CPU devices — and drives the full multi-host path across it:

* host 1's uploaded SceneTables are deliberately perturbed, so the
  host-0 DCN broadcast (``broadcast_scene_tables``) is load-bearing;
* the per-band image pull crosses processes via ``process_allgather``;
* both hosts must assemble the identical full image, and it must equal
  the plain single-process render bit-for-bit (per-lane radiance is
  chip-local; the fleet only partitions and gathers it).

The reference bar is SURVEY.md §2c's multi-chip row (DCN only for
multi-host scene broadcast); the reference itself is single-process
(application.cpp), so this is capability the rebuild adds.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_fleet_matches_single_process(tmp_path):
    port = _free_port()
    outs = [str(tmp_path / f"host{i}.npz") for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", str(port), outs[i]],
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    try:
        logs = [p.communicate(timeout=540)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        # a loaded machine (e.g. the full suite saturating every core)
        # can starve the workers' compiles past any fixed budget — that
        # is an environment limit, not a fleet-correctness failure
        pytest.skip("fleet workers exceeded the time budget (loaded machine)")
    for i, p in enumerate(procs):
        if os.path.exists(outs[i] + ".skip"):
            pytest.skip(open(outs[i] + ".skip").read())
        assert p.returncode == 0, f"host {i} failed:\n{logs[i][-3000:]}"
        assert os.path.exists(outs[i]), f"host {i} wrote no image:\n{logs[i][-3000:]}"

    a, b = (np.load(o) for o in outs)
    np.testing.assert_array_equal(a["img"], b["img"])
    assert int(a["rays"]) == int(b["rays"])

    # equality with the plain single-process path (this pytest process
    # holds its own 8-device CPU mesh, but render_image is unsharded)
    from vulkan_raytracer.render.renderer import render_image
    from vulkan_raytracer.scene.builtin import cornell_box_scene
    from vulkan_raytracer.scene.camera import Camera

    tables = cornell_box_scene().upload()
    cam = Camera(
        position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0])
    )
    img_1, rays_1 = render_image(tables, cam, 24, 16, spp=2, max_depth=2,
                                 tonemap=False)
    np.testing.assert_allclose(a["img"], np.asarray(img_1), rtol=1e-5, atol=1e-6)
    assert int(a["rays"]) == int(rays_1)


@pytest.mark.slow
def test_fleet_detects_dead_peer_without_hanging(tmp_path):
    """Fault injection: host 1 crashes after fleet formation, before any
    collective.  The failure-detection contract (SURVEY §5): the survivor
    must DETECT the dead peer within the collective deadline - terminate,
    classify the error as a peer/collective failure, and never emit a
    result - rather than hang or compute garbage.  Measured behaviour:
    Gloo context init hits DEADLINE_EXCEEDED (~30 s) and the coordination
    service reports the crashed task; the survivor exits in ~2 min."""
    port = _free_port()
    outs = [str(tmp_path / f"host{i}.npz") for i in range(2)]
    env = dict(os.environ, VKRT_TEST_DIE_EARLY="1")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), "2", str(port), outs[i]],
            cwd=REPO,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    try:
        logs = [p.communicate(timeout=420)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail("survivor hung past the detection deadline")

    assert procs[1].returncode == 17  # the injected crash
    if os.path.exists(outs[0] + ".skip"):
        # fleet could not even form on a starved machine - nothing to test
        reason = open(outs[0] + ".skip").read()
        if "distributed init failed" in reason:
            pytest.skip(reason)
        # detection path: the survivor classified the dead peer's
        # collective as failed (deadline / unavailable / connection)
        assert _looks_like_peer_failure(reason), reason
    else:
        assert _looks_like_peer_failure(logs[0]), logs[0][-2000:]
    # the survivor must never have produced an image
    assert not os.path.exists(outs[0])


def _looks_like_peer_failure(text: str) -> bool:
    import re

    return bool(re.search(
        r"DEADLINE_EXCEEDED|timed? ?out|unavailable|connection|crashed|"
        r"failed", text, re.IGNORECASE))
