"""vulkan_raytracer — a glTF path tracer in JAX/Pallas for NVIDIA GPUs.

A from-scratch rebuild of the capability surface of the reference Vulkan
hardware-ray-tracing path tracer (arrebarritra/vulkan-raytracer):

* the GLSL megakernel (``shaders/raygen.rgen``) becomes a wavefront
  integrator over SoA ray pools, compiled as a single XLA program
  (:mod:`vulkan_raytracer.render.integrator`);
* the ``VK_KHR_acceleration_structure`` BLAS/TLAS driver black box becomes a
  software BVH flattened to a *threaded* (skip-pointer) layout, walked per
  ray by a fused Pallas (Triton) kernel (:mod:`vulkan_raytracer.accel.bvh`,
  :mod:`vulkan_raytracer.ops.bvh_kernel`);
* the Vulkan device/memory/synchronisation runtime (~2k LoC of the
  reference) is deleted by construction — XLA owns scheduling and memory;
* multi-chip scaling is pixel-tile data parallelism over a
  ``jax.sharding.Mesh`` (:mod:`vulkan_raytracer.parallel`).

See SURVEY.md at the repo root for the full layer map of the reference and
the mapping of every component onto this package.
"""

__version__ = "0.1.0"
