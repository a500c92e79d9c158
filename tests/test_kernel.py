"""The Triton megakernel's route, runnable on the CPU.

  * interpret mode against the XLA wavefront over mode x sampler x scene
    (sobol draws are shared bit for bit, so those images agree to float
    tolerance; uniform draws differ by design, so those agree in
    distribution);
  * the same kernels lowered for CUDA (`lower(lowering_platforms=
    ("cuda",))` builds the Triton IR without a card), which catches a
    construct the Triton route cannot lower before it reaches the card;
  * the wrapper: padding to whole blocks, the grid, and the key operand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cornelis.integrator import render_chunk
from cornelis.ops import pallas_integrator as pk
from cornelis.rng import make_key
from cornelis.scene.compile import compile_scene
from cornelis.scene.library import cornell_box, sdf_gallery

SCENES = {"cornell": cornell_box, "sdf_gallery": sdf_gallery}
ROUTES = [
    (scene, mode, sampler)
    for scene in SCENES
    for mode in ("path", "nee")
    for sampler in ("uniform", "sobol")
]


def _host(scene_name):
    return pk.host_scene_from_description(SCENES[scene_name]())


@pytest.mark.parametrize("scene_name,mode,sampler", ROUTES)
def test_interpret_matches_wavefront(scene_name, mode, sampler):
    scene = compile_scene(SCENES[scene_name]())
    key = make_key(7)
    w = h = 8
    spp = 8
    kw = dict(width=w, height=h, spp_chunk=spp, spp_total=spp, max_depth=4,
              sampler=sampler, mode=mode)
    p = np.asarray(pk.render_chunk_pallas(
        scene, key, np.uint32(0), interpret=True, block=32, **kw))
    x = np.asarray(render_chunk(scene, key, jnp.uint32(0), **kw))
    assert p.shape == (h, w, 3) and np.isfinite(p).all()
    if sampler == "sobol":
        np.testing.assert_allclose(p, x, rtol=1e-4, atol=1e-4)
    else:
        # Independent draws of one estimator: whole-image channel means
        # within 8 standard errors (plus a small floor).
        for c in range(3):
            sigma = max(x[..., c].std(), p[..., c].std(), 1e-3) / np.sqrt(w * h)
            assert abs(p[..., c].mean() - x[..., c].mean()) < 8 * sigma + 0.05


@pytest.mark.parametrize("scene_name,mode,sampler", ROUTES)
def test_lowers_for_cuda(scene_name, mode, sampler):
    host = _host(scene_name)
    n = 64 * 64 * 4
    fn = pk._build_renderer(
        host, 64, 64, 64, n, pk.DEFAULT_BLOCK, pk.DEFAULT_WARPS, False,
        sampler, 2, mode, pk._host_nee_clamp(host),
    )
    u32 = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.uint32)
    lowered = fn.trace(u32(4), u32(n), u32(n)).lower(lowering_platforms=("cuda",))
    assert "cornelis_megakernel" in lowered.as_text()


@pytest.mark.parametrize("n_rays,block", [(1, 32), (31, 32), (32, 32), (33, 32)])
def test_grid_pads_to_whole_blocks(n_rays, block):
    host = _host("cornell")
    fn = pk._build_renderer(
        host, 4, 4, 4, n_rays, block, 1, True, "uniform", 1, "path", 1.0,
    )
    n_pad = -(-n_rays // block) * block
    r, g, b = fn(jnp.zeros(4, jnp.uint32), jnp.zeros(n_pad, jnp.uint32),
                 jnp.zeros(n_pad, jnp.uint32))
    assert r.shape == g.shape == b.shape == (n_pad,)
    # Pad lanes start dead: they never trace, so they carry no radiance.
    for c in (r, g, b):
        assert np.all(np.asarray(c)[n_rays:] == 0.0)


@pytest.mark.parametrize("block", [16, 64])
def test_image_independent_of_block(block):
    # Keys depend only on (pixel, sample): the block size (and the padding
    # it implies for a 5x3 frame) cannot change a pixel.
    scene = compile_scene(cornell_box())
    kw = dict(width=5, height=3, spp_chunk=3, spp_total=3, max_depth=3,
              interpret=True, sampler="sobol")
    ref = np.asarray(pk.render_chunk_pallas(
        scene, make_key(2), np.uint32(0), block=32, **kw))
    got = np.asarray(pk.render_chunk_pallas(
        scene, make_key(2), np.uint32(0), block=block, **kw))
    np.testing.assert_array_equal(got, ref)


def test_key_operand_is_four_words():
    key = make_key(11)
    words = np.asarray(pk._key_words(key))
    assert words.shape == (4,) and words.dtype == np.uint32
    np.testing.assert_array_equal(
        words[:2], np.asarray(jax.random.key_data(key)).astype(np.uint32)
    )
    assert words[3] == 0


def test_defaults_are_powers_of_two():
    assert pk.DEFAULT_BLOCK & (pk.DEFAULT_BLOCK - 1) == 0
    assert pk.DEFAULT_WARPS & (pk.DEFAULT_WARPS - 1) == 0
    # One ray per thread at most: registers, not lanes, are the limit.
    assert pk.DEFAULT_BLOCK <= 32 * pk.DEFAULT_WARPS
