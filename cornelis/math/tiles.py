"""Frame tiling math.

In the reference, tiles are the unit of CPU parallelism (TBB tasks over
`FrameTiling`, src/Tiles.cpp:5-29, src/Render.cpp:335-354). Here the tile
decomposition instead becomes a *sharding spec*: the pixel grid is split into
per-device regions and into host-side progress/checkpoint chunks. The math
here is pure Python (static shapes feed jit, never traced values).

Reference compatibility notes:
- Tiles are generated row-major, left-to-right bottom-to-top, numbered in
  that order (Tiles.hpp:34-41).
- Bounds are *inclusive* PixelRects (Math.hpp:217-264).
- The reference's spill handling is buggy: it writes the absolute value
  `spill - 1` into pMax instead of tile-relative coordinates
  (src/Tiles.cpp:21-24), wrong whenever the frame is not a tile-size multiple
  AND there is more than one tile on that axis. We implement the evident
  intent (last tile clipped to the frame edge); for exact-multiple frames --
  the only case the reference tests (tests/test_Tiles.cpp:21-37) -- the two
  agree.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple


@dataclass(frozen=True)
class TileBounds:
    """Inclusive pixel-rectangle bounds of one tile."""

    tile_number: int
    min_i: int
    min_j: int
    max_i: int
    max_j: int

    @property
    def width(self) -> int:
        return self.max_i - self.min_i + 1

    @property
    def height(self) -> int:
        return self.max_j - self.min_j + 1

    @property
    def area(self) -> int:
        return self.width * self.height


class FrameTiling:
    """Partition of a (width x height) frame into tiles of at most
    (tile_w x tile_h) pixels."""

    def __init__(self, width: int, height: int, tile_w: int = 32, tile_h: int = 32):
        if width <= 0 or height <= 0:
            raise ValueError("Frame dimensions must be positive.")
        if tile_w <= 0 or tile_h <= 0:
            raise ValueError("Tile dimensions must be positive.")
        self.width = width
        self.height = height
        self.tile_w = tile_w
        self.tile_h = tile_h

        num_x = width // tile_w + (1 if width % tile_w else 0)
        num_y = height // tile_h + (1 if height % tile_h else 0)
        self.num_x = num_x
        self.num_y = num_y

        tiles: List[TileBounds] = []
        number = 0
        for j in range(num_y):
            for i in range(num_x):
                min_i = i * tile_w
                min_j = j * tile_h
                max_i = min((i + 1) * tile_w, width) - 1
                max_j = min((j + 1) * tile_h, height) - 1
                tiles.append(TileBounds(number, min_i, min_j, max_i, max_j))
                number += 1
        self._tiles = tiles

    def __len__(self) -> int:
        return len(self._tiles)

    def __iter__(self) -> Iterator[TileBounds]:
        return iter(self._tiles)

    def __getitem__(self, k: int) -> TileBounds:
        return self._tiles[k]


def tile_major_order(width: int, height: int, tile_w: int = 32, tile_h: int = 32):
    """Pixel ids (row-major frame indices) reordered tile-major.

    This is FrameTiling as a *sharding spec* (SURVEY section 2 #10): the
    mesh render permutes its pixel axis into this order before splitting it
    over the `tiles` mesh axis, so each device owns whole 32x32-ish image
    tiles -- the reference's unit of parallel work (src/Render.cpp:335-354)
    -- instead of thin row bands. Returns a numpy uint32 permutation of
    range(width*height); pure host math (static shapes feed jit).
    """
    import numpy as np

    tiling = FrameTiling(width, height, tile_w, tile_h)
    ids = np.empty(width * height, np.uint32)
    k = 0
    for t in tiling:
        for j in range(t.min_j, t.max_j + 1):
            row = j * width
            ids[k : k + t.width] = np.arange(
                row + t.min_i, row + t.max_i + 1, dtype=np.uint32
            )
            k += t.width
    return ids


def split_evenly(n: int, parts: int) -> List[Tuple[int, int]]:
    """Split range(n) into `parts` contiguous (start, size) chunks whose sizes
    differ by at most one. Used to assign pixel rows / ray ranges to devices."""
    base, rem = divmod(n, parts)
    out = []
    start = 0
    for p in range(parts):
        size = base + (1 if p < rem else 0)
        out.append((start, size))
        start += size
    return out


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m
