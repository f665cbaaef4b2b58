from raytracing_jax.cli import main
from raytracing_jax.utils import compile_cache

compile_cache.enable()
raise SystemExit(main())
