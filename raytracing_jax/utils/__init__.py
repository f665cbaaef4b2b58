from raytracing_jax.utils import color, vec3  # noqa: F401
