"""Tests that need a GPU: the compiled Triton megakernel on the card.

Each takes the `gpu` fixture (conftest.py), so here on the CPU they skip;
chip_smoke.py runs them on the card (`python -m pytest -m gpu tests/`).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from cornelis.integrator import render_chunk
from cornelis.ops.pallas_integrator import render_chunk_pallas
from cornelis.rng import make_key
from cornelis.scene.compile import compile_scene
from cornelis.scene.library import cornell_box

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("mode", ["path", "nee"])
def test_compiled_kernel_matches_wavefront(gpu, mode):
    # Shared sobol draws; the compiled kernel and XLA differ by ulps in
    # their transcendental lowerings, which knife-edge decisions amplify
    # on a sparse set of paths -- so: image means agree to MC noise and
    # the median pixel to float precision (chip_smoke.py's parity bounds).
    scene = compile_scene(cornell_box())
    kw = dict(width=64, height=64, spp_chunk=16, spp_total=16, max_depth=16,
              sampler="sobol", mode=mode)
    p = np.asarray(render_chunk_pallas(scene, make_key(4), np.uint32(0), **kw))
    x = np.asarray(render_chunk(scene, make_key(4), jnp.uint32(0), **kw))
    assert np.isfinite(p).all()
    rel = np.abs(p - x) / (np.abs(x) + 1.0)
    assert np.median(rel) < 1e-5
    np.testing.assert_allclose(p.mean(axis=(0, 1)), x.mean(axis=(0, 1)), rtol=2e-2)


def test_session_renders_on_the_kernel(gpu):
    from cornelis.options import RenderOptions
    from cornelis.render import RenderSession

    res = RenderSession(
        cornell_box(), RenderOptions(width=64, height=64, samples_aa=16, output=None)
    ).render()
    assert res.backend == "pallas"
    assert np.isfinite(res.image).all() and res.image.mean() > 0.05


@pytest.mark.parametrize(
    "rule", ["rr_schedule", "clamp_schedule", "nee_direct_emitter"]
)
def test_depth_rules_on_card(gpu, rule):
    sys.path.insert(0, os.path.dirname(__file__))
    from test_integrator import check_depth_rules

    check_depth_rules(rule)
