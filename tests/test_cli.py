"""CLI tests (the reference binary has no argument parsing at all,
src/cornelis.cpp:76-79; ours is a real flag surface -- SURVEY §5 config)."""

import json
import os

import numpy as np
import pytest

from cornelis.cli import build_parser, load_scene, main, parse_mesh
from cornelis.scene.description import SceneDescription
from cornelis.scene.library import cornell_box


class TestParsing:
    def test_defaults_match_reference_main(self):
        args = build_parser().parse_args([])
        # Reference main(): Cornell scene, 4096 spp, 512x512, fixed output
        # name (src/cornelis.cpp:77, src/Render.cpp:264,307).
        assert args.scene == "cornell"
        assert args.spp == 4096
        assert (args.width, args.height) == (512, 512)
        assert args.output == "cornelisrender2.png"

    def test_parse_mesh(self):
        assert parse_mesh(None) is None
        assert parse_mesh("4x2") == (4, 2)
        assert parse_mesh("8") == (8, 1)
        with pytest.raises(SystemExit):
            parse_mesh("axb")
        with pytest.raises(SystemExit):
            parse_mesh("0x2")

    def test_unknown_scene_errors(self):
        with pytest.raises(SystemExit):
            load_scene("no-such-scene-or-file")


class TestInformational:
    def test_list_scenes(self, capsys):
        assert main(["--list-scenes"]) == 0
        out = capsys.readouterr().out
        assert "cornell" in out and "sphere-plane" in out

    def test_dump_scene_roundtrips(self, capsys):
        assert main(["--dump-scene", "cornell"]) == 0
        dumped = capsys.readouterr().out
        scene = SceneDescription.from_dict(json.loads(dumped))
        assert scene.to_dict() == cornell_box().to_dict()


class TestEndToEnd:
    def _render_args(self, out, extra=()):
        return [
            "--scene",
            "sphere-plane",
            "--spp",
            "2",
            "--width",
            "16",
            "--height",
            "16",
            "--max-depth",
            "2",
            "-o",
            str(out),
            "--quiet",
            *extra,
        ]

    def test_render_writes_png(self, tmp_path):
        out = tmp_path / "render.png"
        assert main(self._render_args(out)) == 0
        assert out.exists()
        from cornelis.utils.png import read_png

        img = read_png(str(out))
        assert img.shape == (16, 16, 3)

    def test_render_scene_file(self, tmp_path):
        scene_file = tmp_path / "scene.json"
        cornell_box().save(str(scene_file))
        out = tmp_path / "render.png"
        assert main(self._render_args(out)[:0] + [
            "--scene", str(scene_file), "--spp", "1", "--width", "8",
            "--height", "8", "--max-depth", "1", "-o", str(out), "--quiet",
        ]) == 0
        assert out.exists()

    def test_rerender_is_bitwise_identical(self, tmp_path):
        # Multi-chunk CLI renders depend only on (scene, options, seed).
        out = tmp_path / "render.png"
        args = self._render_args(out, extra=("--spp-chunk", "1"))
        assert main(args) == 0
        from cornelis.utils.png import read_png

        first = read_png(str(out))
        os.remove(out)
        assert main(args) == 0
        np.testing.assert_array_equal(read_png(str(out)), first)

    def test_render_sobol(self, tmp_path):
        out = tmp_path / "render.png"
        assert main(self._render_args(out, extra=("--sampler", "sobol"))) == 0
        from cornelis.utils.png import read_png

        assert read_png(str(out)).max() > 0

    def test_checkpoint_resume(self, tmp_path):
        out = tmp_path / "render.png"
        ckpt = tmp_path / "film.ckpt"
        args = self._render_args(out, extra=("--checkpoint", str(ckpt), "--spp-chunk", "1"))
        assert main(args) == 0
        assert ckpt.exists()
        from cornelis.film import Film

        film, next_sample, _ = Film.load_checkpoint(str(ckpt))
        assert next_sample == 2
        assert film.sample_count == 2
        # Resuming a finished render is a no-op that still writes the image.
        os.remove(out)
        assert main(args) == 0
        assert out.exists()
