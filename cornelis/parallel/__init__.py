"""Mesh parallelism: the accelerator replacement for the reference's TBB
tile scheduler (src/Render.cpp:335-354). See mesh.py and render.py."""

from .mesh import SAMPLE_AXIS, TILE_AXIS, initialize_distributed, make_mesh
from .render import render_chunk_mesh, render_chunk_mesh_pallas

__all__ = [
    "SAMPLE_AXIS",
    "TILE_AXIS",
    "initialize_distributed",
    "make_mesh",
    "render_chunk_mesh",
    "render_chunk_mesh_pallas",
]
