"""Native C++ host-runtime tests (native/cornelis_native.cpp).

Cross-checks every native entry point against the pure-Python reference
implementation: byte-identical PNG container, sRGB quantization within 1
count (libm pow vs XLA pow can differ in the last ulp), exact accumulate.
Skips cleanly when no compiler is available.
"""

import numpy as np
import pytest

from cornelis import native
from cornelis.film import Film
from cornelis.math import color as pycolor
from cornelis.utils import png as pypng

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable (no g++/zlib)"
)


def _random_image(h=33, w=47, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


class TestPng:
    def test_roundtrip_through_python_reader(self, tmp_path):
        img = _random_image()
        path = tmp_path / "native.png"
        assert native.write_png(str(path), img)
        got = pypng.read_png(str(path))
        assert np.array_equal(got, img)

    def test_encode_matches_python_encoder_bytes(self):
        # Same filter strategy (None) + same zlib level => identical bytes.
        img = _random_image(seed=1)
        nat = native.encode_png(img, compress_level=6)
        ref = pypng.encode_png(img, compress_level=6)
        assert nat == ref

    def test_encode_size_consistency(self):
        img = _random_image(5, 7, seed=2)
        data = native.encode_png(img)
        assert data is not None and data[:8] == b"\x89PNG\r\n\x1a\n"


class TestSrgbQuantize:
    @pytest.mark.parametrize("standard", [False, True])
    def test_matches_python_within_one_count(self, standard):
        rng = np.random.default_rng(3)
        linear = rng.random((64, 64, 3), np.float32) * 1.5  # includes >1 values
        linear[0, 0] = 0.0
        linear[0, 1] = 0.0031308  # segment boundary
        nat = native.srgb_quantize(linear, standard=standard)
        ref = np.asarray(
            pycolor.quantize_to_8bit(pycolor.srgb_encode(linear, standard=standard))
        )
        diff = np.abs(nat.astype(int) - ref.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.01  # ulp disagreements are rare

    def test_negative_radiance_clamps_to_zero(self):
        linear = np.array([[[-0.5, -1e-9, 0.0]]], np.float32)
        nat = native.srgb_quantize(linear)
        assert nat.min() >= 0 and nat[0, 0, 2] == 0


class TestAccumulate:
    def test_matches_numpy(self):
        rng = np.random.default_rng(4)
        dst = rng.random((16, 16, 3)).astype(np.float32)
        src = rng.random((16, 16, 3)).astype(np.float32)
        want = dst + src
        assert native.accumulate(dst, src)
        assert np.array_equal(dst, want)

    def test_rejects_mismatched(self):
        dst = np.zeros((4, 4, 3), np.float32)
        assert not native.accumulate(dst[::2], np.zeros((2, 4, 3), np.float32))


class TestFilmIntegration:
    def test_film_save_png_native_vs_python(self, tmp_path):
        rng = np.random.default_rng(5)
        film = Film(24, 16)
        film.add_samples(rng.random((16, 24, 3)).astype(np.float32) * 4, 4)

        p_nat = tmp_path / "nat.png"
        film.save_png(str(p_nat))

        # Force the pure-Python path via the env kill-switch in a subprocess-
        # free way: call the fallback pieces directly.
        srgb_py = np.asarray(
            pycolor.quantize_to_8bit(pycolor.srgb_encode(film.image()))
        )
        a = pypng.read_png(str(p_nat)).astype(int)
        assert np.abs(a - srgb_py.astype(int)).max() <= 1
