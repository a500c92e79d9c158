"""Session logging.

Mirrors the reference's loguru session header -- render options and scene
stats in scoped sections at session start, throttled percent-complete lines
during the render (src/Render.cpp:315-325,349-352) -- on Python's stdlib
logging.
"""

from __future__ import annotations

import logging

logger = logging.getLogger("cornelis")
if not logger.handlers:
    _handler = logging.StreamHandler()
    _handler.setFormatter(
        logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    )
    logger.addHandler(_handler)
    logger.setLevel(logging.INFO)


def log_session_header(options, scene_arrays) -> None:
    """Options + scene stats at session start (Render.cpp:315-325)."""
    logger.info("Starting render session.")
    logger.info("Render Options:")
    logger.info("  AA Samples %4d", options.samples_aa)
    logger.info("  Resolution %dx%d", options.width, options.height)
    logger.info("  Max depth  %4d", options.max_depth)
    logger.info("  Seed       %d", options.seed)
    logger.info("Scene information:")
    logger.info("  Spheres   %4d", scene_arrays.num_spheres)
    logger.info("  Planes    %4d", scene_arrays.num_planes)
    logger.info("  Materials %4d", scene_arrays.num_materials)
