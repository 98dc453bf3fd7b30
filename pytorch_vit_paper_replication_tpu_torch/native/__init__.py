"""ctypes bridge to the native JPEG fast path (``jpeg_loader.cc``).

The port's copy of the JAX package's ``native`` module. The C++ source
(a copy of the JAX package's) compiles with ``g++ -O3 -shared -fPIC ...
-ljpeg`` at first use into the package's git-ignored ``_build/``, named by
a digest of the source and the flags (as :mod:`..ops._build` names the
CUDA libraries), so an edited source rebuilds and an unchanged one loads
the existing library. Exposes:

* :func:`available` — True when the toolchain and libjpeg exist and the
  library compiled and loaded. The decoder is optional on the host: every
  consumer branches on this and keeps the PIL path otherwise, and the
  cause (:func:`unavailable_reason`) is printed once.
* :func:`decode_jpeg` — bytes -> uint8 ``[S, S, 3]`` via libjpeg's scaled
  decode and a fused resize/crop (modes ``"squash"`` /
  ``"shorter_crop"``, matching ``transforms.Resize`` /
  ``ResizeShorter + CenterCrop``).
* :func:`decode_jpeg_file` — the same, from a path.
* :func:`resize_crop`, :func:`resize_crop_f32`, :func:`u8_to_f32` — the
  array passes of the packed-shard augmentation (``data/imagenet.py``):
  a bilinear crop+resize of a uint8 HWC frame, the same fused with the
  flip and the float affine, and the affine alone. Each returns None when
  the library is unavailable, and the caller takes its composed path.

Host code, not device kernels. Thread-safe: the build is locked and the
C call releases the GIL (ctypes does), so loader threads decode in
parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "jpeg_loader.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg",)
_MODES = {"squash": 0, "shorter_crop": 1}
_ABI = 3

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_reason: Optional[str] = None


def library_path() -> Path:
    """Where the decoder library lives for the current source and flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"libjpeg_loader-{h.hexdigest()[:16]}.so"


def _compile(path: Path) -> Optional[str]:
    """Build ``path``; returns None on success, else why it failed. The
    output goes to a process-unique temp name and is renamed into place,
    so concurrent first uses never load a half-written file."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "g++ not found"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + f".tmp.{os.getpid()}")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
        if proc.returncode != 0:
            return (f"g++ exit {proc.returncode}: "
                    f"{proc.stderr.strip()[-400:]}")
        os.replace(tmp, path)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ failed: {type(e).__name__}: {e}"
    finally:
        tmp.unlink(missing_ok=True)
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.psr_decode_jpeg.restype = ctypes.c_int
    lib.psr_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.psr_abi_version.restype = ctypes.c_int
    lib.psr_abi_version.argtypes = []
    lib.psr_resize_crop.restype = ctypes.c_int
    lib.psr_resize_crop.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
    lib.psr_resize_crop_f32.restype = ctypes.c_int
    lib.psr_resize_crop_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
    lib.psr_u8_to_f32.restype = ctypes.c_int
    lib.psr_u8_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float)]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _reason
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.is_file():
            _reason = _compile(path)
        if _reason is None:
            try:
                lib = _bind(ctypes.CDLL(str(path)))
                if lib.psr_abi_version() != _ABI:
                    _reason = (f"{path.name}: ABI {lib.psr_abi_version()} "
                               f"!= {_ABI}")
                else:
                    _lib = lib
            except (OSError, AttributeError) as e:
                _reason = f"cannot load {path.name}: {e}"
        if _reason is not None:
            print(f"[native] JPEG decoder unavailable ({_reason}); "
                  "decoding with PIL", file=sys.stderr)
        return _lib


def available() -> bool:
    """Whether the native decoder compiled and loaded on this host."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why :func:`available` is False (None when it is True)."""
    _load()
    return _reason


def decode_jpeg(data: bytes, target: int, mode: str = "squash",
                resize: Optional[int] = None) -> Optional[np.ndarray]:
    """Decode a JPEG byte stream to uint8 ``[target, target, 3]`` RGB.

    ``mode="squash"`` is ``Resize((target, target))``; ``"shorter_crop"``
    is ``ResizeShorter(resize) + CenterCrop(target)`` (``resize`` defaults
    to ``target``). Returns None when the native library is unavailable or
    the stream cannot be decoded (corrupt data, exotic color space) —
    callers fall back to PIL, which handles the long tail.
    """
    lib = _load()
    if lib is None:
        return None
    out = np.empty((target, target, 3), np.uint8)
    rc = lib.psr_decode_jpeg(
        data, len(data), resize if resize is not None else target, target,
        _MODES[mode], out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 0:
        return None
    return out


def decode_jpeg_file(path, target: int, mode: str = "squash",
                     resize: Optional[int] = None) -> Optional[np.ndarray]:
    """:func:`decode_jpeg` from a file path (None on any failure)."""
    try:
        data = Path(path).read_bytes()
    except OSError:
        return None
    return decode_jpeg(data, target, mode, resize)


def _hwc_u8(arr: np.ndarray) -> bool:
    return arr.dtype == np.uint8 and arr.ndim == 3 and arr.shape[2] == 3


def resize_crop(arr: np.ndarray, top: int, left: int, crop_h: int,
                crop_w: int, target: int) -> Optional[np.ndarray]:
    """Bilinear-resize a crop box of a uint8 HWC RGB array to
    ``[target, target, 3]`` in one native pass (PIL crop+resize affine).
    None when unavailable or the box/array is unsupported.

    No antialiasing: point-sampled bilinear matches PIL closely up to
    ~1.5x reductions (the RandomResizedCrop-on-packed-shards regime,
    where reduction <= pack_size/image_size) but aliases beyond that —
    for heavy downscales use the PIL path.
    """
    lib = _load()
    if lib is None or not _hwc_u8(arr):
        return None
    arr = np.ascontiguousarray(arr)
    out = np.empty((target, target, 3), np.uint8)
    rc = lib.psr_resize_crop(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        arr.shape[0], arr.shape[1], top, left, crop_h, crop_w, target,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def _f3(v) -> np.ndarray:
    """Broadcast a scalar or [3] vector to a contiguous float32 [3]."""
    return np.ascontiguousarray(np.broadcast_to(
        np.asarray(v, np.float32), (3,)))


def resize_crop_f32(arr: np.ndarray, top: int, left: int, crop_h: int,
                    crop_w: int, target: int, *, hflip: bool = False,
                    scale=1.0 / 255.0, offset=0.0) -> Optional[np.ndarray]:
    """Fused RandomResizedCrop(+flip)+normalize: one native pass from a
    uint8 HWC frame to float32 ``[target, target, 3]`` with
    ``out = round_u8(bilinear) * scale + offset`` per channel. Bit-equal
    to :func:`resize_crop` + flip + the numpy affine. None when
    unavailable/unsupported (callers fall back)."""
    lib = _load()
    if lib is None or not _hwc_u8(arr):
        return None
    arr = np.ascontiguousarray(arr)
    s, o = _f3(scale), _f3(offset)
    out = np.empty((target, target, 3), np.float32)
    rc = lib.psr_resize_crop_f32(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        arr.shape[0], arr.shape[1], top, left, crop_h, crop_w, target,
        1 if hflip else 0,
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None


def u8_to_f32(arr: np.ndarray, scale=1.0 / 255.0,
              offset=0.0) -> Optional[np.ndarray]:
    """uint8 HWC RGB -> float32 with a fused per-channel affine
    (``x * scale + offset``). None when unavailable/unsupported."""
    lib = _load()
    if lib is None or not _hwc_u8(arr):
        return None
    arr = np.ascontiguousarray(arr)
    s, o = _f3(scale), _f3(offset)
    out = np.empty(arr.shape, np.float32)
    rc = lib.psr_u8_to_f32(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        arr.shape[0] * arr.shape[1],
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        o.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out if rc == 0 else None
