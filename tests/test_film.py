"""Film, PNG codec, and checkpoint tests."""

import numpy as np
import pytest

from cornelis.film import Film, load_image_linear, mse
from cornelis.utils.png import encode_png, read_png, write_png


class TestPng:
    def test_roundtrip(self, tmp_path):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
        p = str(tmp_path / "t.png")
        write_png(p, img)
        back = read_png(p)
        assert np.array_equal(img, back)

    def test_signature(self):
        data = encode_png(np.zeros((4, 4, 3), np.uint8))
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        assert b"IHDR" in data and b"IDAT" in data and b"IEND" in data

    def test_rejects_bad_input(self):
        with pytest.raises(ValueError):
            encode_png(np.zeros((4, 4, 3), np.float32))


class TestFilm:
    def test_dimensions_validated(self):
        # FrameBuffer ctor throws on degenerate dims (test_FrameBuffer.cpp:7-14).
        with pytest.raises(ValueError):
            Film(0, 10)

    def test_aspect(self):
        assert Film(20, 10).aspect == pytest.approx(2.0)

    def test_accumulate_average(self):
        film = Film(2, 2)
        film.add_samples(np.full((2, 2, 3), 4.0, np.float32), 4)
        film.add_samples(np.full((2, 2, 3), 8.0, np.float32), 4)
        assert np.allclose(film.image(), 1.5)

    def test_empty_film_black(self):
        assert np.all(Film(2, 2).image() == 0)

    def test_srgb8_output(self):
        film = Film(1, 1)
        film.add_samples(np.ones((1, 1, 3), np.float32), 1)
        assert np.all(film.to_srgb8() == 255)

    def test_save_load_roundtrip(self, tmp_path):
        film = Film(8, 8)
        rng = np.random.default_rng(1)
        film.add_samples(rng.random((8, 8, 3)).astype(np.float32), 1)
        p = str(tmp_path / "img.png")
        film.save_png(p)
        back = load_image_linear(p)
        # 8-bit quantization bounds the roundtrip error.
        assert mse(film.image(), back) < 1e-4

    def test_checkpoint_roundtrip(self, tmp_path):
        film = Film(4, 4)
        film.add_samples(np.full((4, 4, 3), 2.0, np.float32), 16)
        p = str(tmp_path / "ckpt.npz")
        film.save_checkpoint(p, next_sample=16, seed=99)
        loaded, next_sample, seed = Film.load_checkpoint(p)
        assert next_sample == 16 and seed == 99
        assert loaded.sample_count == 16
        assert np.allclose(loaded.radiance_sum, film.radiance_sum)
