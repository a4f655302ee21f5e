"""Renderer: progressive accumulation, tonemapped output, headless batching.

The JAX counterpart of the Raytracer layer (src/raytracer.cpp): owns the
accumulation buffer (RGBA32F image, raytracer.cpp:129-144), the progressive
sample counter (raytracer.cpp:534), camera-move resets (raytracer.cpp:503),
and the tonemapped display image (shaders/raygen.rgen:90-99).  The ~1,500
LoC of pipeline/SBT/descriptor plumbing (raytracer.cpp:147-449) has no
analogue: XLA compiles the whole frame into one program.

Two APIs:
* :class:`Renderer` — interactive/progressive, one sample per
  :meth:`Renderer.draw_frame` exactly like the reference's render loop;
* :func:`render_image` — headless batch: ``spp`` samples in a single jitted
  ``lax.scan`` with fixed-order accumulation (bit-reproducible for a given
  chunking), the new capability the reference lacks (it has no image
  writer, SURVEY.md §5).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.tonemap import reinhard_jodie
from ..scene.camera import Camera
from ..scene.scenegraph import SceneTables
from .integrator import render_sample


@functools.partial(jax.jit, static_argnums=(3, 4, 6), static_argnames=("nee_weighting",))
def _render_one(tables, view_inv, proj_inv, width, height, sample_count, max_depth,
                nee_weighting="reference"):
    return render_sample(
        tables, view_inv, proj_inv, width, height, sample_count, max_depth,
        nee_weighting=nee_weighting,
    )


#: Max pixel lanes per traversal pass.  Large frames render in sequential
#: lane bands, which bounds live wavefront state in device memory and
#: keeps each dispatch's duration bounded.
MAX_LANES_PER_PASS = 1 << 19


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6), static_argnames=("nee_weighting",))
def _render_batch(tables, view_inv, proj_inv, width, height, max_depth, spp,
                  start_sample, nee_weighting="reference"):
    """Sum ``spp`` samples starting at ``start_sample`` in fixed scan order.

    Samples are batched into waves of up to MAX_LANES_PER_PASS lanes
    (lane = (pixel, sample)).  Frames above MAX_LANES_PER_PASS lanes are
    traced in sequential bands of a globally 32x32-block-swizzled lane
    order; the final inverse permutation restores pixel order once.
    """
    n = width * height
    if n > MAX_LANES_PER_PASS:
        raise ValueError("use render_image (banded) above MAX_LANES_PER_PASS")
    s_batch = min(spp, max(1, MAX_LANES_PER_PASS // n))
    while spp % s_batch:
        s_batch -= 1
    from .integrator import _block_order

    lanes = jnp.asarray(_block_order(width, height)[0])

    def step(acc, svec):
        radiance, rays = _render_wave(
            tables, view_inv, proj_inv, width, height, max_depth, svec,
            lanes, nee_weighting,
        )
        return acc + radiance, rays

    init = jnp.zeros((n, 3), jnp.float32)
    samples = (start_sample + jnp.arange(spp, dtype=jnp.uint32)).reshape(
        -1, s_batch
    )
    acc, rays = jax.lax.scan(step, init, samples)
    return jnp.zeros_like(acc).at[lanes].set(acc), rays


def _render_wave(tables, view_inv, proj_inv, width, height, max_depth,
                 samples, lanes, nee_weighting):
    """One multi-sample wave: lane = (sample, pixel), samples-major so each
    sample's pixel blocks stay contiguous.  Returns
    radiance aligned with ``lanes`` (callers scatter to pixel order)."""
    n = lanes.shape[0]
    s_batch = samples.shape[0]
    if s_batch == 1:
        return render_sample(
            tables, view_inv, proj_inv, width, height, samples[0], max_depth,
            lane_idx=lanes, nee_weighting=nee_weighting,
        )
    lane_t = jnp.tile(lanes, s_batch)
    samp = jnp.repeat(samples, n, total_repeat_length=s_batch * n)
    radiance, rays = render_sample(
        tables, view_inv, proj_inv, width, height, samp, max_depth,
        lane_idx=lane_t, nee_weighting=nee_weighting,
    )
    return radiance.reshape(s_batch, n, 3).sum(axis=0), rays


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6), static_argnames=("nee_weighting",))
def _render_band(tables, view_inv, proj_inv, width, height, max_depth, spp,
                 start_sample, lanes, nee_weighting="reference"):
    """One lane band, all spp, as its own device dispatch (bands keep each
    dispatch bounded and give host-side progress)."""

    samples = start_sample + jnp.arange(spp, dtype=jnp.uint32)
    return _render_wave(
        tables, view_inv, proj_inv, width, height, max_depth, samples,
        lanes, nee_weighting,
    )


def default_spp_chunk(spp: int) -> int:
    """Samples per banded wave: trade pixels-per-band for samples-per-wave
    at the fixed MAX_LANES_PER_PASS dispatch bound.  Default 8
    (VKRT_SPP_CHUNK overrides)."""
    return min(spp, int(os.environ.get("VKRT_SPP_CHUNK", "8")))


def _render_batch_banded(tables, view_inv, proj_inv, width, height, max_depth,
                         spp, start_sample, nee_weighting="reference"):
    from .integrator import _block_order

    n = width * height
    # each dispatch traces one wave of band_pixels x spp_chunk lanes; the
    # sample batch rides in the wave (tighter bounce-sort bins) instead of
    # a sequential scan, at the same per-dispatch work bound
    spp_chunk = default_spp_chunk(spp)
    n_bands = -(-n * spp_chunk // MAX_LANES_PER_PASS)
    per = -(-n // n_bands)
    order, inverse = _block_order(width, height)
    acc_bands = []
    rays = np.zeros((), np.int64)
    # ragged last band (at most one extra compile shape) instead of padded
    # duplicate lanes: padding would re-trace real pixels and inflate the
    # ray counter, desyncing it from the sharded path's
    for b in range(-(-n // per)):
        lanes = jnp.asarray(order[b * per : (b + 1) * per])
        acc = np.zeros((lanes.shape[0], 3), np.float32)
        s0 = int(start_sample)
        done = 0
        while done < spp:
            c = min(spp_chunk, spp - done)
            a, r = _render_band(
                tables, view_inv, proj_inv, width, height, max_depth, c,
                jnp.uint32(s0 + done), lanes, nee_weighting=nee_weighting,
            )
            acc += np.asarray(a)  # sync: one dispatch per (band, chunk)
            rays = rays + np.asarray(r, np.int64).sum()
            done += c
        acc_bands.append(acc)
    acc = np.concatenate(acc_bands)[np.asarray(inverse)]
    return jnp.asarray(acc), rays


def _banded_preferred(tables, width: int, height: int, spp: int) -> bool:
    """Dispatch rule for :func:`render_image`.

    Above MAX_LANES_PER_PASS banding is mandatory.  Below it, only the
    opt-in coherence repacking (``integrator._repack``) prefers the banded
    layout once the frame can't fit ``spp_chunk`` sample-batched copies in
    one wave: more samples of one pixel block pack tighter sort bins.
    Otherwise the single-wave scan avoids per-band dispatch overhead."""
    n = width * height
    if n > MAX_LANES_PER_PASS:
        return True
    if spp < 2:
        return False
    from .integrator import _repack

    return _repack() and n * default_spp_chunk(spp) > MAX_LANES_PER_PASS


def camera_uniforms(camera: Camera):
    """CameraProperties equivalent (raytracer.h:18-20)."""
    return (
        jnp.asarray(camera.view_inverse(), jnp.float32),
        jnp.asarray(camera.projection_inverse(), jnp.float32),
    )


def render_image(
    tables: SceneTables,
    camera: Camera,
    width: int,
    height: int,
    spp: int,
    max_depth: int = 5,
    start_sample: int = 1,
    tonemap: bool = True,
    nee_weighting: str = "reference",
    as_uint8: bool = False,
):
    """Headless render: returns ((H, W, 3) float array, total_rays).

    ``start_sample`` defaults to 1 so the accumulated image matches the
    reference's steady state (sample 0 is the preview frame and is excluded
    from its accumulation buffer, raygen.rgen:95-96).  ``as_uint8`` maps
    to the display format on-device (the reference's present path) and
    fetches 4x less data over the host link.
    """
    camera.aspect = width / height
    view_inv, proj_inv = camera_uniforms(camera)
    batch = (
        _render_batch_banded
        if _banded_preferred(tables, width, height, spp)
        else _render_batch
    )
    acc, rays = batch(
        tables, view_inv, proj_inv, width, height, max_depth, spp,
        jnp.uint32(start_sample), nee_weighting=nee_weighting,
    )
    img = _postprocess(acc, spp, tonemap, as_uint8)
    img = jax.device_get(img).reshape(height, width, 3)
    total_rays = int(np.asarray(jax.device_get(rays), dtype=np.int64).sum())
    return img, total_rays


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _postprocess(acc, spp, tonemap, as_uint8):
    img = acc / jnp.float32(spp)
    if tonemap:
        img = reinhard_jodie(img)
    if as_uint8:
        img = (jnp.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
    return img


@functools.partial(
    jax.jit,
    static_argnums=(3, 4, 6, 7, 8),
    donate_argnums=(5,),
)
def _frame_step(tables, view_inv, proj_inv, width, height, accum,
                max_depth, disp_h, disp_w, sample_count):
    """ONE device program per interactive frame: render the progressive
    sample, accumulate (donated buffer — no copy), tonemap, quantise to
    uint8 and mean-pool to the display size, instead of ~6 separate
    dispatches per frame (render, add, divide, tonemap, clip, plus a
    ray-counter sync), each a host round trip.  Fusing them is the
    swapchain-present analogue (raytracer.cpp:518-533 copies on-device
    too)."""
    radiance, rays = render_sample(
        tables, view_inv, proj_inv, width, height, sample_count, max_depth
    )
    preview = sample_count == jnp.uint32(0)
    # the preview sample is excluded from the accumulation buffer
    # (raygen.rgen:95-96): it is displayed directly and then discarded
    accum = jnp.where(preview, jnp.zeros_like(radiance), accum + radiance)
    display = accum / jnp.maximum(sample_count, 1).astype(jnp.float32)
    img = reinhard_jodie(jnp.where(preview, radiance, display))
    img8 = (jnp.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
    img8 = img8.reshape(height, width, 3)
    if (disp_h, disp_w) != (height, width):
        # decimate to the terminal cell grid on device: fetch disp_h*disp_w
        # cells instead of the full frame (a tty cannot show 800x600 cells;
        # the decimation IS the present blit)
        fy, fx = height // disp_h, width // disp_w
        img8 = (
            img8[: disp_h * fy, : disp_w * fx]
            .reshape(disp_h, fy, disp_w, fx, 3)
            .astype(jnp.uint16)
            .mean(axis=(1, 3))
            .astype(jnp.uint8)
        )
    return accum, img8, rays


class Renderer:
    """Progressive renderer with the reference's frame-loop semantics.

    drawFrame (raytracer.cpp:501-535): reset the sample counter when the
    camera moved, render one sample, accumulate (samples >= 1), tonemap
    ``accumulated / sampleCount`` for display.
    """

    def __init__(
        self,
        tables: SceneTables,
        camera: Camera,
        width: int,
        height: int,
        max_depth: int = 5,
    ):
        self.tables = tables
        self.camera = camera
        self.width = width
        self.height = height
        self.max_depth = max_depth
        self.sample_count = 0
        self.accum = jnp.zeros((width * height, 3), jnp.float32)
        self.total_rays = 0
        self._rays_pending = []  # device counters, folded lazily
        camera.aspect = width / height

    def handle_resize(self, width: int, height: int) -> None:
        """raytracer.cpp:493-499: new images, reset accumulation.  Any
        pipelined in-flight frame is dropped too: it was rendered for the
        old present target (the swapchain analogue recreates images)."""
        self.width, self.height = width, height
        self.camera.aspect = width / height
        self.accum = jnp.zeros((width * height, 3), jnp.float32)
        self.sample_count = 0
        self._inflight = None

    def reset_accumulation(self) -> None:
        self.sample_count = 0

    def _fold_rays(self) -> None:
        if self._rays_pending:
            self.total_rays += int(
                np.sum([np.asarray(r, np.int64) for r in self._rays_pending])
            )
            self._rays_pending = []

    @property
    def rays_traced(self) -> int:
        self._fold_rays()
        return self.total_rays

    def draw_frame(self, display_size=None, pipeline: bool = False):
        """Render one progressive sample; returns the tonemapped uint8
        display image — (H, W, 3), or ``display_size`` = (disp_h, disp_w)
        mean-pooled on device (interactive present path).

        ``pipeline=True`` is the swapchain-latency mode: the call enqueues
        frame N and returns frame N-1's display image (None on the very
        first call), so the host fetch of one frame overlaps the next
        frame's device execution — the same one-frame latency a swapchain
        present has (raytracer.cpp:518-533).  jax dispatch is async; only
        the device_get blocks."""
        if self.camera.position_changed or self.camera.direction_changed:
            self.sample_count = 0  # raytracer.cpp:503
            self.camera.position_changed = False
            self.camera.direction_changed = False
        view_inv, proj_inv = camera_uniforms(self.camera)
        disp_h, disp_w = display_size or (self.height, self.width)
        self.accum, img8, rays = _frame_step(
            self.tables, view_inv, proj_inv, self.width, self.height,
            self.accum, self.max_depth, disp_h, disp_w,
            jnp.uint32(self.sample_count),
        )
        # the ray counter stays on device: a per-frame device_get would
        # serialise the frame loop on the host link
        self._rays_pending.append(rays)
        self.sample_count += 1
        if not pipeline:
            return np.asarray(jax.device_get(img8))
        prev, self._inflight = getattr(self, "_inflight", None), img8
        return np.asarray(jax.device_get(prev)) if prev is not None else None
