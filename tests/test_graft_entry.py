"""Driver entry points compile and run (single-chip + 8-device CPU mesh)."""

import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as ge


def test_entry_jits_single_chip():
    fn, args = ge.entry()
    rgb, rays = jax.jit(fn)(*args)
    rgb = np.asarray(rgb)
    assert rgb.shape == (4096, 3)
    assert np.isfinite(rgb).all()
    assert float(rays) > 0


def test_dryrun_multichip_8():
    ge.dryrun_multichip(8)
