from raytracing_jax.models.scene import (  # noqa: F401
    BVH,
    Background,
    Camera,
    MaterialTable,
    Scene,
    Spheres,
    TextureAtlas,
    Triangles,
)
