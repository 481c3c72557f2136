"""ctypes binding of the native audio decoder (port of
``whisper_tpu.native.audio_native``).

``audio_decode.cc`` (a copy of the JAX package's source) decodes any
container and codec libavformat/libavcodec read (wav, flac, mp3, aac,
vorbis: the reference's symphonia set, ref Cargo.toml:19, src/main.rs:
228-316), downmixes to mono by the channel mean, and carries the
reference-exact linear resampler ``wt_resample_linear``.

The library is built at first use, as ``ops/kernels.py`` builds the CUDA
kernels: ``g++ -O2 -fPIC -std=c++17 -Wall -Wextra -ffp-contract=off
-shared ... -lavformat -lavcodec -lavutil`` (the flags of the JAX package's
Makefile) into ``build/native/<source hash>/`` at the root of the checkout,
which ``.gitignore`` lists.  ``WHISPER_TPU_TORCH_AUDIO_LIB`` names a
library to load instead (a sanitizer build, say).  ``available()`` says
whether it loads; when it does not, ``unavailable_reason()`` says why (no
g++, no libav headers, or the compiler's output), and ``audio.io`` quotes
it in its error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "audio_decode.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libwhisper_tpu_torch_audio.so"
LIB_ENV = "WHISPER_TPU_TORCH_AUDIO_LIB"
CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-Wextra",
            "-ffp-contract=off")
LDLIBS = ("-lavformat", "-lavcodec", "-lavutil")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
_reason = ""          # why the library is not available
_lock = threading.Lock()  # the CLI's prefetch thread may load it too


def source_hash() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXXFLAGS + LDLIBS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile ``audio_decode.cc`` unless a build of this source exists;
    raises RuntimeError with the reason when it cannot."""
    lib_path = BUILD_ROOT / source_hash() / LIB_NAME
    if lib_path.is_file():
        return lib_path
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++ not found)")
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib_path.parent) as tmp:
        tmp_lib = os.path.join(tmp, LIB_NAME)
        cmd = [cxx, *CXXFLAGS, "-shared", "-o", tmp_lib, str(SOURCE),
               *LDLIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            out = (proc.stdout + proc.stderr).strip()
            missing = re.search(r"(libav\w+/\w+\.h): No such file", out)
            if missing:
                raise RuntimeError(
                    f"no libav headers ({missing.group(1)} not found; the "
                    "libavformat, libavcodec and libavutil development "
                    "packages are needed)")
            raise RuntimeError(f"g++ failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{out[-2000:]}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    # int wt_decode_mono(const char* path, float** out, long* n, int* sr)
    lib.wt_decode_mono.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.wt_decode_mono.restype = ctypes.c_int
    lib.wt_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.wt_free.restype = None
    lib.wt_last_error.argtypes = []
    lib.wt_last_error.restype = ctypes.c_char_p
    lib.wt_resample_len.argtypes = [ctypes.c_long, ctypes.c_int, ctypes.c_int]
    lib.wt_resample_len.restype = ctypes.c_long
    lib.wt_resample_linear.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
    ]
    lib.wt_resample_linear.restype = None
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted, _reason
    with _lock:
        if _load_attempted:
            return _lib
        _load_attempted = True
        try:
            path = os.environ.get(LIB_ENV) or str(build())
            _lib = _bind(ctypes.CDLL(path))
        except (OSError, RuntimeError, AttributeError) as e:
            _reason = str(e)
            _lib = None
        return _lib


def reset() -> None:
    """Forget the load attempt (the next call builds or loads again)."""
    global _lib, _load_attempted, _reason
    with _lock:
        _lib, _load_attempted, _reason = None, False, ""


def available() -> bool:
    return _load() is not None


def unavailable_reason() -> str:
    """Why the library did not load ("" when it did)."""
    _load()
    return _reason


def decode_mono(path: str) -> Tuple[np.ndarray, int]:
    """Decode any supported container/codec to mono float32 + sample rate."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native audio library not available: {_reason}")
    out = ctypes.POINTER(ctypes.c_float)()
    n = ctypes.c_long(0)
    sr = ctypes.c_int(0)
    rc = lib.wt_decode_mono(path.encode(), ctypes.byref(out),
                            ctypes.byref(n), ctypes.byref(sr))
    if rc != 0:
        err = lib.wt_last_error()
        raise RuntimeError(
            f"native decode failed ({rc}): {err.decode() if err else path}")
    try:
        data = np.ctypeslib.as_array(out, shape=(n.value,)).copy()
    finally:
        lib.wt_free(out)
    return data, sr.value


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Reference-exact linear resample in C++, bit-equal to
    ``audio.resample._resample_linear_numpy``."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native resampler not available: {_reason}")
    x = np.ascontiguousarray(x, dtype=np.float32)
    n_out = lib.wt_resample_len(len(x), sr_in, sr_out)
    out = np.empty(n_out, dtype=np.float32)
    lib.wt_resample_linear(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x),
        sr_in, sr_out,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_out,
    )
    return out
