"""raytracing_jax — a wavefront path-tracing framework for accelerators.

Built from scratch in JAX/XLA (Pallas for hot kernels) with the capabilities of
the C reference `FrancisTheCat/raytracing_c` (see SURVEY.md):

- OBJ/MTL and glTF/GLB scene loading (reference: driver.c:510-728)
- SoA triangle store + implicit complete 8-ary BVH (reference: scene.h:44-97)
- Wavefront path integrator with Disney/PBR ubershader (reference:
  raytracer.c:505-558, driver.c:287-418)
- Equirectangular environment lighting (reference: driver.c:95-104)
- Firefly median denoiser (reference: denoiser.c)
- Lightmap baking (reference: raytracer.c:722-784)
- Scene serialization cache (reference: scene.c:13-76)
- PNG/QOI/PPM output (reference: driver.c:839-874)

The architecture is accelerator-first: per-pixel recursion becomes bounce-synchronous
batched stages over flat ray arenas; SIMD lanes become batch dimensions;
threads/atomics become `jax.sharding` over a device mesh.
"""

__version__ = "0.1.0"

EPSILON = 1.0e-4  # reference: common.h:8
BVH_WIDTH = 8     # reference: raytracer.h:6 (SIMD_WIDTH)
