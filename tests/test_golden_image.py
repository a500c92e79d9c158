"""End-to-end golden: our render vs the reference renderer's ACTUAL output.

BASELINE.md's correctness bar: the Cornell render must match the reference
CPU output within Monte-Carlo noise. tests/golden/reference_cornell_512.png
is produced by the reference's own RenderSession (src/Render.cpp:296-363)
via tools/oracle/build_golden.sh at 16384 spp (upgraded from 4096 in
round 3; BASELINE.md's stated 16k-spp bar) with seed 19791102 and every
reference quirk live (12.95 sRGB encode, emission-every-hit, RR constants,
camera skew).

Comparison design:
  * the two renderers share no RNG bits (Xoshiro vs threefry), so the
    comparison is distributional: region means at matched image-plane
    regions. Region means are resolution-independent (each estimates the
    integral of radiance over its image-plane rectangle), so our side
    renders at 128x128 -- cheap on the CPU CI -- against the 512x512 golden
    on an 8x8 region grid;
  * the golden passed through toSRGB + 8-bit quantization
    (FrameBuffer.hpp:91-107), which CLAMPS linear radiance at 1.0. Clamping
    a 4096-sample pixel mean and clamping a 96-sample pixel mean are
    different estimators (the noisier one is biased low near the clip), so
    regions where any golden pixel saturates are excluded and the rest are
    compared UNCLAMPED. At this scene 27/64 regions are clip-free --
    measured agreement there: mean signed diff -0.002, max |diff| 0.057 at
    96 spp.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from cornelis.integrator import render_chunk
from cornelis.math.color import srgb_decode
from cornelis.rng import make_key
from cornelis.scene.compile import compile_scene
from cornelis.scene.library import cornell_box
from cornelis.utils.png import read_png

GOLDEN = os.path.join(
    os.path.dirname(__file__), "golden", "reference_cornell_512.png"
)

W = H = 128
SPP = 96
GRID = 8


def block_means(img: np.ndarray, grid: int) -> np.ndarray:
    h, w, c = img.shape
    return img.reshape(grid, h // grid, grid, w // grid, c).mean(axis=(1, 3))


@pytest.fixture(scope="module")
def golden():
    raw8 = read_png(GOLDEN)
    raw = raw8.astype(np.float32) / 255.0
    # Invert the reference's 12.95-variant sRGB encode (Color.cpp:47,68).
    linear = np.asarray(srgb_decode(jnp.asarray(raw), standard=False))
    # Per-region fraction of pixels at/near the 8-bit ceiling: those
    # regions lost information to the clamp and are excluded.
    gh = raw8.shape[0] // GRID
    gw = raw8.shape[1] // GRID
    clip_frac = (
        (raw8.max(axis=-1) >= 250).reshape(GRID, gh, GRID, gw).mean(axis=(1, 3))
    )
    return linear, clip_frac


@pytest.fixture(scope="module")
def ours_linear() -> np.ndarray:
    scene = compile_scene(cornell_box())
    key = make_key()  # reference default seed (both sides, by default)
    acc = np.zeros((H, W, 3), np.float32)
    chunk = SPP // 2
    for off in (0, chunk):
        acc += np.asarray(
            render_chunk(
                scene,
                key,
                jnp.uint32(off),
                width=W,
                height=H,
                spp_chunk=chunk,
                spp_total=SPP,
                max_depth=64,
            )
        )
    return acc / SPP


class TestGoldenImage:
    def test_region_means_match(self, golden, ours_linear):
        gold_linear, clip_frac = golden
        ref = block_means(gold_linear, GRID)
        got = block_means(ours_linear, GRID)
        clean = clip_frac < 0.001
        assert clean.sum() >= 20, "golden unexpectedly clip-dominated"

        # Our per-region stderr estimate: spread of pixel means inside the
        # region (includes real spatial variation -- conservative) over
        # sqrt(pixels per region); the golden's own noise at 16384 spp is an
        # order of magnitude below ours at 96 spp. 0.02 absolute covers
        # 8-bit quantization.
        px_per_block = (H // GRID) * (W // GRID)
        blocks = ours_linear.reshape(GRID, H // GRID, GRID, W // GRID, 3)
        stderr = blocks.std(axis=(1, 3)) / np.sqrt(px_per_block)
        tol = 6.0 * stderr + 0.02
        diff = np.abs(got - ref)
        bad = clean[..., None] & (diff >= tol)
        assert not bad.any(), (
            f"max clean-region diff {diff[clean].max():.4f}; "
            f"violations at {np.argwhere(bad)}"
        )

    def test_clean_region_aggregate_unbiased(self, golden, ours_linear):
        # Across all clip-free regions the mean signed difference must be
        # ~zero -- catches global brightness bias (wrong RR, wrong emission
        # accounting, wrong sRGB transfer) that per-region tolerances could
        # individually absorb.
        #
        # Bound 0.02 with a KNOWN +1-2% asymmetry: the reference binary
        # loses a little energy to unguarded float32 self-intersections
        # (its absolute 1e-4 bounce offset vs ~1.2e-4 hit-position rounding
        # at this scene's coordinate scale; COMPAT.md R10). Our guarded
        # render sits between the reference binary and a float64
        # transcription of the reference's algorithm, slightly ABOVE the
        # binary -- e.g. region (4,4): reference 16k-spp 0.457, ours 0.466,
        # float64 oracle 0.471 (round-3 investigation, GOLDEN_512.md).
        gold_linear, clip_frac = golden
        ref = block_means(gold_linear, GRID)
        got = block_means(ours_linear, GRID)
        clean = clip_frac < 0.001
        signed = (got - ref)[clean]
        bias = signed.mean(axis=0)
        assert np.all(np.abs(bias) < 0.02), f"aggregate bias {bias}"
        # The asymmetry has a KNOWN sign: ours is never darker in aggregate.
        assert np.all(bias > -0.01), f"unexpected dark bias {bias}"

    def test_wall_colors(self, golden, ours_linear):
        # Structural invariants on both images: the left wall is
        # green-dominant, the right wall red-dominant (cornellBox material
        # assignment, src/cornelis.cpp:30-38).
        gold_linear, _ = golden
        for img in (gold_linear, ours_linear):
            h, w, _ = img.shape
            left = img[h // 4 : 3 * h // 4, : w // 8].mean(axis=(0, 1))
            right = img[h // 4 : 3 * h // 4, -w // 8 :].mean(axis=(0, 1))
            assert left[1] > left[0] and left[1] > left[2]
            assert right[0] > right[1] and right[0] > right[2]
