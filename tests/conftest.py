"""Test configuration: run everything on a virtual 8-device CPU mesh.

Per SURVEY §4: the same jitted code that runs on the GPU runs on the CPU
backend in CI; Pallas kernels run in interpret mode (interpret=True). The
platform is forced here, before any computation.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Full-suite runs accumulate hundreds of live compiled executables;
    the XLA:CPU compiler then segfaulted DETERMINISTICALLY while compiling
    a tiered-repair traversal program in a since-removed module (3/3
    whole-suite runs died at the same test in backend_compile_and_load;
    the same test passes standalone and per-file, and a 64 MB main-thread
    stack does not help — the crash is inside XLA's own compile). Dropping
    the in-process executable caches at module boundaries keeps the
    compiler's working set bounded. Costs recompiles (~+20% suite time);
    removes the crash."""
    jax.clear_caches()
    yield
