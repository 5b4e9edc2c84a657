"""ctypes bindings for the native C++ image pipeline (imagepipe.cpp).

A port of `mydetection_tpu/native/__init__.py`; `imagepipe.cpp` is a
copy of the JAX package's source. The library is built on first use
with g++ into `build/native/libimagepipe-<hash>.so` at the repository
root (a directory git ignores), never beside the source. The hash
covers the source, the compiler flags and the host's CPU (the `model
name` and `flags` lines of /proc/cpuinfo): the build is `-march=native`,
and a library built on another CPU could die on an illegal instruction,
which no Python code can catch, so a library is only loaded on the kind
of host that built it. A build writes a temporary name and
`os.replace`s it, so concurrent builds leave one whole library.

Callers check `available()` and use the PIL path otherwise (a host
without g++ or libjpeg's headers). ctypes releases the GIL for the
duration of each call, so the decode thread pool in `data.loader` gets
true decode parallelism through this path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "imagepipe.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-shared", "-fPIC")
LIBS = ("-ljpeg",)

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def cpu_signature(cpuinfo: str | None = None) -> str:
    """The host CPU as the build depends on it: the first `model name`
    and `flags` lines of /proc/cpuinfo (`cpuinfo` stands in for the
    file), or the platform's machine and processor where there is no
    such file."""
    if cpuinfo is None:
        try:
            cpuinfo = Path("/proc/cpuinfo").read_text()
        except OSError:
            return f"{platform.machine()} {platform.processor()}"
    picked = {}
    for line in cpuinfo.splitlines():
        key, _, value = line.partition(":")
        key = key.strip()
        if key in ("model name", "flags") and key not in picked:
            picked[key] = value.strip()
    return f"{picked.get('model name', '')}\n{picked.get('flags', '')}"


def library_path(build_dir: Path = BUILD_DIR, *,
                 source: bytes | None = None,
                 flags: tuple[str, ...] = CXX_FLAGS,
                 cpu: str | None = None) -> Path:
    """Where the library for this source, these flags and this CPU
    lives."""
    digest = hashlib.sha256(SRC.read_bytes() if source is None else source)
    digest.update(" ".join(flags + LIBS).encode())
    digest.update((cpu_signature() if cpu is None else cpu).encode())
    return Path(build_dir) / f"libimagepipe-{digest.hexdigest()[:16]}.so"


def build(out: Path) -> None:
    """Compile the source into `out` through a temporary name that is
    `os.replace`d into place; raises RuntimeError on failure."""
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC), *LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{type(e).__name__}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(proc.stderr[-2000:])
    os.replace(tmp, out)


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        path = library_path()
        try:
            if not path.exists():
                build(path)
            lib = ctypes.CDLL(str(path))
        except (RuntimeError, OSError) as e:
            _build_error = str(e)
            return None
        lib.decode_letterbox_jpeg.restype = ctypes.c_int
        lib.decode_letterbox_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)]
        lib.letterbox_rgb.restype = ctypes.c_int
        lib.letterbox_rgb.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def _geom_to_info(geom: np.ndarray, input_size: int):
    from mydetection_tpu_torch.utils.image_ops import LetterboxInfo

    return LetterboxInfo(
        ori_w=int(round(float(geom[3]))), ori_h=int(round(float(geom[4]))),
        ratio=float(geom[0]), pad_x=float(geom[1]), pad_y=float(geom[2]),
        input_size=input_size)


def decode_letterbox_jpeg(data: bytes, input_size: int):
    """JPEG bytes → (canvas u8 (S, S, 3), LetterboxInfo). Raises on
    decode failure (the caller falls back to PIL)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native imagepipe unavailable: {_build_error}")
    canvas = np.empty((input_size, input_size, 3), np.uint8)
    geom = np.empty(5, np.float32)
    rc = lib.decode_letterbox_jpeg(
        data, len(data), input_size,
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        geom.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"libjpeg decode failed (rc={rc})")
    return canvas, _geom_to_info(geom, input_size)


def decode_letterbox_file(path: str, input_size: int):
    with open(path, "rb") as fh:
        return decode_letterbox_jpeg(fh.read(), input_size)


def letterbox_rgb(img: np.ndarray, input_size: int):
    """HWC RGB uint8 → (canvas, LetterboxInfo) via the native resampler."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native imagepipe unavailable: {_build_error}")
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"letterbox_rgb expects HWC RGB uint8, got "
                         f"shape {img.shape}")
    h, w = img.shape[:2]
    if h == 0 or w == 0:
        # mirror the Python path's guard (utils/image_ops): the C++
        # ratio would be inf and the geometry NaN
        raise ValueError(f"letterbox_rgb: empty image (shape {img.shape})")
    canvas = np.empty((input_size, input_size, 3), np.uint8)
    geom = np.empty(5, np.float32)
    rc = lib.letterbox_rgb(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, input_size,
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        geom.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"native letterbox failed (rc={rc})")
    return canvas, _geom_to_info(geom, input_size)
