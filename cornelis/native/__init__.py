"""Native C++ host-runtime: build + ctypes bindings.

The reference's image-output runtime is native (vendored stb_image_write C,
src/Render.cpp:257-265); ours is cornelis_native.cpp, compiled on first use
with g++ and loaded via ctypes (no pybind11 in the image). Everything here
degrades gracefully: if no compiler/zlib is available, `load()` returns None
and callers (film.py, utils/png.py) fall back to the pure-Python paths.

Set CORNELIS_NO_NATIVE=1 to force the pure-Python fallback (used by tests to
compare both implementations).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "cornelis_native.cpp")
_ABI_VERSION = 1

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _build_dir() -> str:
    d = os.path.join(os.path.dirname(__file__), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _source_tag() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def build(verbose: bool = False) -> Optional[str]:
    """Compile the shared library if needed; returns its path or None."""
    tag = _source_tag()
    out = os.path.join(_build_dir(), f"libcornelis_native_{tag}.so")
    if os.path.exists(out):
        return out
    # A per-process temporary: concurrent first uses (test workers) each
    # build their own copy and atomically rename it into place.
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-Wall",
        "-Wextra",
        _SRC,
        "-o",
        tmp,
        "-lz",
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if proc.returncode != 0:
        if verbose:
            print(proc.stderr)
        return None
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.cn_abi_version.restype = ctypes.c_int
    lib.cn_srgb_quantize.argtypes = [f32p, u8p, ctypes.c_int64, ctypes.c_int]
    lib.cn_srgb_quantize.restype = None
    lib.cn_accumulate.argtypes = [f32p, f32p, ctypes.c_int64]
    lib.cn_accumulate.restype = None
    lib.cn_film_average.argtypes = [f32p, f32p, ctypes.c_int64, ctypes.c_double]
    lib.cn_film_average.restype = None
    lib.cn_encode_png_size.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int]
    lib.cn_encode_png_size.restype = ctypes.c_int64
    lib.cn_encode_png.argtypes = [
        u8p,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int,
        u8p,
        ctypes.c_int64,
    ]
    lib.cn_encode_png.restype = ctypes.c_int64
    lib.cn_write_png.argtypes = [
        ctypes.c_char_p,
        u8p,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int,
    ]
    lib.cn_write_png.restype = ctypes.c_int
    return lib


def load() -> Optional[ctypes.CDLL]:
    """Build (if needed) and load the native library, or None on failure."""
    global _lib, _load_attempted
    if os.environ.get("CORNELIS_NO_NATIVE"):
        return None
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    path = build()
    if path is None:
        return None
    try:
        lib = _bind(ctypes.CDLL(path))
        if lib.cn_abi_version() != _ABI_VERSION:
            return None
    except OSError:
        return None
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


# -- numpy-facing wrappers ---------------------------------------------------


def _as_f32_c(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def srgb_quantize(linear: np.ndarray, standard: bool = False) -> Optional[np.ndarray]:
    """Linear float RGB -> sRGB uint8 via the native path, or None."""
    lib = load()
    if lib is None:
        return None
    src = _as_f32_c(linear)
    out = np.empty(src.shape, np.uint8)
    lib.cn_srgb_quantize(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        src.size,
        1 if standard else 0,
    )
    return out


def accumulate(dst: np.ndarray, src: np.ndarray) -> bool:
    """dst += src in place (both float32, C-contiguous); False -> caller
    should fall back to numpy."""
    lib = load()
    if lib is None:
        return False
    if (
        dst.dtype != np.float32
        or not dst.flags.c_contiguous
        or dst.shape != src.shape
    ):
        return False
    s = _as_f32_c(src)
    lib.cn_accumulate(
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        dst.size,
    )
    return True


def encode_png(image: np.ndarray, compress_level: int = 6) -> Optional[bytes]:
    """Encode (H, W, 3) uint8 RGB to PNG bytes via the native encoder."""
    lib = load()
    if lib is None:
        return None
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("encode_png expects an (H, W, 3) uint8 array.")
    h, w, _ = img.shape
    p = img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    size = lib.cn_encode_png_size(p, w, h, compress_level)
    if size < 0:
        return None
    buf = np.empty(size, np.uint8)
    written = lib.cn_encode_png(
        p, w, h, compress_level, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size
    )
    if written != size:
        return None
    return buf.tobytes()


def write_png(path: str, image: np.ndarray, compress_level: int = 6) -> bool:
    """Write a PNG via the native encoder; False -> caller falls back."""
    lib = load()
    if lib is None:
        return False
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("write_png expects an (H, W, 3) uint8 array.")
    h, w, _ = img.shape
    # Write to a temp file in the target directory and rename, so a failed
    # encode never leaves a truncated PNG behind.
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(suffix=".png.tmp", dir=d)
    os.close(fd)
    rc = lib.cn_write_png(
        tmp.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h, compress_level
    )
    if rc != 0:
        os.unlink(tmp)
        return False
    os.replace(tmp, path)
    return True
