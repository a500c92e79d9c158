"""Matched-resolution golden check on the COMMITTED artifacts.

tools/matched_golden.py renders Cornell at the reference's own 512x512
(16384 spp, seed 19791102) on an accelerator and commits the result as
tests/golden/ours_cornell_512.png next to the reference renderer's output.
This test re-verifies the committed pair on every run (cheap: two PNG
decodes), so the repository's stated golden agreement (GOLDEN_512.md) can
never silently drift from the artifacts. The live-render golden (CPU CI,
128x128) stays in test_golden_image.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from cornelis.math.color import srgb_decode
from cornelis.utils.png import read_png

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
REF = os.path.join(GOLDEN_DIR, "reference_cornell_512.png")
OURS = os.path.join(GOLDEN_DIR, "ours_cornell_512.png")

GRID = 16

# Provenance pins (GOLDEN_512.md "Artifact provenance"): the documented
# hashes of the committed artifacts. A mismatch means the PNG was swapped
# without updating the provenance record + re-deriving the tolerances.
REF_SHA256 = "44ce1e495ed9f9dd44ef494c59c3ca008de1ed18bc44666657b3a31d8fba234e"
OURS_SHA256 = "720f0dd0c07d9d9bb87c95a30c2e74dae510fc595b7ee41b0dc0b0e0819cb613"


def test_artifact_provenance_hashes():
    import hashlib

    for path, expect in ((REF, REF_SHA256), (OURS, OURS_SHA256)):
        with open(path, "rb") as f:
            got = hashlib.sha256(f.read()).hexdigest()
        assert got == expect, (
            f"{os.path.basename(path)} sha256 {got} != documented {expect} "
            "(update GOLDEN_512.md provenance + re-derive tolerances if "
            "the regeneration was intentional)"
        )


def _linear(path):
    raw8 = read_png(path)
    lin = np.asarray(
        srgb_decode(jnp.asarray(raw8.astype(np.float32) / 255.0), standard=False)
    )
    return raw8, lin


def _block_means(img, grid):
    h, w, c = img.shape
    return img.reshape(grid, h // grid, grid, w // grid, c).mean(axis=(1, 3))


@pytest.mark.skipif(
    not os.path.exists(OURS),
    reason="ours_cornell_512.png not rendered yet (tools/matched_golden.py)",
)
class TestMatchedResolutionGolden:
    def test_clean_region_means_match(self):
        ref8, ref_lin = _linear(REF)
        _, ours_lin = _linear(OURS)
        assert ref_lin.shape == ours_lin.shape == (512, 512, 3)

        ref_m = _block_means(ref_lin, GRID)
        ours_m = _block_means(ours_lin, GRID)
        gh = 512 // GRID
        clip = (
            (ref8.max(axis=-1) >= 250).reshape(GRID, gh, GRID, gh).mean(axis=(1, 3))
        )
        clean = clip < 0.001
        # Measured: 193/256 regions clip-free against the 16k-spp golden.
        assert clean.mean() >= 0.6, f"only {clean.mean():.0%} regions clip-free"

        diff = np.abs(ours_m - ref_m).max(axis=-1)
        # Measured max clean-region diff 0.0725 -- a KNOWN one-sided
        # asymmetry: the reference binary loses energy to unguarded float32
        # self-intersections (worst on the ceiling near the tangent light).
        # Round 4 swept the f64 oracle over ALL 34 regions with diff > 0.03
        # (tests/golden/arbitration_sweep_r4.json): OURS is the closer
        # realization of the reference's own algorithm in 34/34, agreeing
        # with the oracle to <=0.015 everywhere except two gold-sphere
        # glossy regions (0.050/0.058, where the oracle's own MC variance
        # is largest). Bound = measured 0.0725 worst diff + ~15% headroom
        # (tightened from the round-3 0.10 per the sweep).
        assert diff[clean].max() < 0.085, f"max clean diff {diff[clean].max():.4f}"

        signed = (ours_m - ref_m)[clean]
        bias = signed.mean(axis=0)
        # Aggregate: ours sits 1-2% ABOVE the reference binary (the
        # asymmetry's sign is fixed) and never below.
        assert np.all(bias > -0.005) and np.all(bias < 0.03), f"bias {bias}"
