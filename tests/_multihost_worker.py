"""Subprocess worker for tests/test_multihost_2proc.py — one fleet host.

Runs as ``python tests/_multihost_worker.py <pid> <nprocs> <port> <out.npz>``.
Each process contributes 4 virtual CPU devices to a real
``jax.distributed`` fleet over localhost (Gloo collectives — the same
cross-host seam a multi-host GPU fleet crosses).  Host 1 perturbs
its uploaded SceneTables before the broadcast, so the test proves
``broadcast_scene_tables`` actually repairs host divergence rather than
relying on every host building identical bytes.

Not a pytest module (leading underscore keeps it out of collection).
"""

import os
import re
import sys

# 4 virtual devices per process, replacing any inherited force-count
# (the parent pytest env carries =8 from tests/conftest.py).
flags = os.environ.get("XLA_FLAGS", "")
flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "", flags)
os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=4").strip()
# the fleet runs on CPU devices only: a worker never opens an accelerator
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402


_ENV_FAILURE = re.compile(
    r"timed?[ _-]?out|deadline|unavailable|connection|too slow", re.IGNORECASE
)


def main() -> None:
    pid, nprocs, port, out_path = (
        int(sys.argv[1]),
        int(sys.argv[2]),
        sys.argv[3],
        sys.argv[4],
    )
    try:
        jax.distributed.initialize(
            f"127.0.0.1:{port}", num_processes=nprocs, process_id=pid
        )
    except Exception as e:  # environment cannot form a fleet: tell the parent
        with open(out_path + ".skip", "w") as f:
            f.write(f"distributed init failed: {e}")
        return
    try:
        _run_fleet(pid, nprocs, out_path)
    except Exception as e:
        # Gloo collectives carry a ~30 s deadline; on a loaded single-core
        # host one worker's compile can starve its peer past it.  That is
        # an environment limit, not a fleet bug — distinguish it from real
        # correctness failures so the parent can skip instead of fail.
        if _ENV_FAILURE.search(str(e)):
            with open(out_path + ".skip", "w") as f:
                f.write(f"fleet collective starved (loaded machine): {e}")
            return
        raise


def _run_fleet(pid: int, nprocs: int, out_path: str) -> None:

    import numpy as np

    from vulkan_raytracer.parallel.multihost import (
        broadcast_scene_tables,
        is_io_host,
        render_image_multihost,
    )
    from vulkan_raytracer.scene.builtin import cornell_box_scene
    from vulkan_raytracer.scene.camera import Camera

    assert jax.process_count() == nprocs, jax.process_count()
    assert jax.device_count() == 4 * nprocs, jax.device_count()
    assert is_io_host() == (pid == 0)

    if os.environ.get("VKRT_TEST_DIE_EARLY") and pid == 1:
        # fault injection (tests/test_multihost_2proc.py): this host
        # crashes after fleet formation, before any collective - the
        # survivor must DETECT the dead peer within the collective
        # deadline, not hang
        os._exit(17)

    tables = cornell_box_scene().upload()
    if pid != 0:
        # diverge this host's scene bytes: double the first float leaf
        leaves, treedef = jax.tree.flatten(tables)
        for i, leaf in enumerate(leaves):
            if hasattr(leaf, "dtype") and leaf.dtype == np.float32:
                leaves[i] = leaf * 2.0
                break
        tables = jax.tree.unflatten(treedef, leaves)
    tables = broadcast_scene_tables(tables)

    cam = Camera(
        position=np.array([0.0, 1.0, 2.4]), direction=np.array([0.0, 0.0, -1.0])
    )
    img, rays = render_image_multihost(
        tables, cam, 24, 16, spp=2, max_depth=2, tonemap=False
    )
    np.savez(out_path, img=np.asarray(img), rays=int(rays))


if __name__ == "__main__":
    main()
