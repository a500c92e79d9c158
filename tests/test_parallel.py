"""Mesh-sharding tests on the 8-device virtual CPU mesh (conftest.py).

The key property (SURVEY.md section 5 "race detection" analog): the rendered
image is invariant to the device mesh shape, because RNG keys depend only on
global ray ids. This is the determinism guarantee the reference documents
for its per-tile jump-ahead streams (Tiles.hpp:22-31), strengthened to
cover arbitrary resharding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cornelis.integrator import render_chunk
from cornelis.parallel import make_mesh, render_chunk_mesh
from cornelis.rng import make_key
from cornelis.scene.compile import compile_scene
from cornelis.scene.library import cornell_box

W = H = 32
SPP = 8
COMMON = dict(width=W, height=H, spp_chunk=SPP, spp_total=SPP, max_depth=8)


@pytest.fixture(scope="module")
def scene():
    return compile_scene(cornell_box())


@pytest.fixture(scope="module")
def reference_image(scene):
    return np.asarray(
        render_chunk(scene, make_key(3), jnp.uint32(0), **COMMON)
    )


def test_requires_eight_devices():
    assert jax.device_count() >= 8, "conftest should provide 8 CPU devices"


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8), (2, 1)])
def test_mesh_shape_invariance(scene, reference_image, shape):
    mesh = make_mesh(shape, devices=jax.devices()[: shape[0] * shape[1]])
    img = np.asarray(
        render_chunk_mesh(scene, make_key(3), jnp.uint32(0), mesh=mesh, **COMMON)
    )
    # Sharding the sample axis changes float32 summation order; tiles-only
    # sharding is bit-identical.
    atol = 0.0 if shape[1] == 1 else 1e-4
    np.testing.assert_allclose(img, reference_image, atol=atol, rtol=1e-5)


def test_indivisible_raises(scene):
    mesh = make_mesh((8, 1))
    with pytest.raises(ValueError, match="divisible"):
        render_chunk_mesh(
            scene,
            make_key(3),
            jnp.uint32(0),
            mesh=mesh,
            width=30,
            height=30,
            spp_chunk=SPP,
            spp_total=SPP,
            max_depth=4,
        )


def test_output_is_row_sharded(scene):
    mesh = make_mesh((8, 1))
    img = render_chunk_mesh(scene, make_key(3), jnp.uint32(0), mesh=mesh, **COMMON)
    shardings = {d.device for d in img.addressable_shards}
    assert len(shardings) == 8


def test_session_mesh_path_matches_single_device(tmp_path):
    from cornelis.options import RenderOptions
    from cornelis.render import RenderSession

    common = dict(width=32, height=32, samples_aa=16, spp_chunk=8, seed=11, output=None)
    single = RenderSession(cornell_box(), RenderOptions(**common)).render()
    meshed = RenderSession(
        cornell_box(), RenderOptions(**common, mesh_shape=(4, 2))
    ).render()
    np.testing.assert_allclose(meshed.image, single.image, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tile_size", [8, 12, 0])
def test_tile_sharding_invariance(scene, reference_image, tile_size):
    # FrameTiling as the sharding spec (math/tiles.py tile_major_order):
    # the image must be bit-identical whatever the tile decomposition --
    # 8 (exact multiple, 16 tiles), 12 (ragged spill tiles), 0 (flat
    # row-band fallback) -- because keys depend on pixel ids, not batch
    # position, and only the `tiles` axis is sharded (no psum).
    mesh = make_mesh((8, 1))
    img = np.asarray(
        render_chunk_mesh(
            scene, make_key(3), jnp.uint32(0), mesh=mesh, tile_size=tile_size, **COMMON
        )
    )
    np.testing.assert_array_equal(img, reference_image)


def test_tile_major_order_is_permutation():
    from cornelis.math.tiles import tile_major_order

    for w, h, t in ((32, 32, 8), (20, 12, 8), (7, 5, 3)):
        perm = tile_major_order(w, h, t, t)
        assert sorted(perm.tolist()) == list(range(w * h))
    # First tile's pixels come first (row-major inside the tile).
    perm = tile_major_order(8, 8, 4, 4)
    assert perm[:4].tolist() == [0, 1, 2, 3]
    assert perm[4:8].tolist() == [8, 9, 10, 11]


class TestMeshPallas:
    """The megakernel under shard_map (interpret mode on the CPU mesh)."""

    def test_matches_single_device_megakernel(self, scene):
        from cornelis.ops.pallas_integrator import render_chunk_pallas
        from cornelis.parallel import render_chunk_mesh_pallas

        single = np.asarray(
            render_chunk_pallas(
                scene, make_key(3), np.uint32(0), interpret=True, **COMMON
            )
        )
        for shape in ((8, 1), (4, 2), (2, 4)):
            mesh = make_mesh(shape)
            img = np.asarray(
                render_chunk_mesh_pallas(
                    scene,
                    make_key(3),
                    jnp.uint32(0),
                    mesh=mesh,
                    interpret=True,
                    **COMMON,
                )
            )
            # Same draws (keys by pixel/sample ids), same kernel math; only
            # the samples-axis psum changes float reduction order.
            atol = 0.0 if shape[1] == 1 else 1e-4
            np.testing.assert_allclose(img, single, atol=atol, rtol=1e-5)

    def test_sobol_mesh_megakernel(self, scene):
        from cornelis.parallel import render_chunk_mesh_pallas

        mesh = make_mesh((4, 2))
        img = np.asarray(
            render_chunk_mesh_pallas(
                scene,
                make_key(3),
                jnp.uint32(0),
                mesh=mesh,
                interpret=True,
                sampler="sobol",
                **COMMON,
            )
        )
        xla = np.asarray(
            render_chunk_mesh(
                scene, make_key(3), jnp.uint32(0), mesh=make_mesh((4, 2)),
                sampler="sobol", **COMMON,
            )
        )
        # Sobol draws are bit-shared between backends; on CPU interpret
        # mode the physics lowering matches too.
        np.testing.assert_allclose(img, xla, rtol=1e-4, atol=1e-4)
