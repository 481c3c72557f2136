"""Build and load the package's CUDA kernels (``csrc/*.cu``) for Hopper.

The sources are compiled with ``nvcc`` for ``sm_90a`` at first use into
one shared library with a plain C interface, loaded with ``ctypes``.  The
library lives under ``build/kernels/<hash>/`` at the root of the checkout
(listed in ``.gitignore``), keyed by a hash of the sources and the flags,
so an edited kernel is rebuilt and an unchanged one is loaded as it is.

Every C entry point launches on the stream it is given (the wrapper
passes ``torch.cuda.current_stream()``), never synchronises, allocates
nothing, and returns ``cudaGetLastError()``; ``check`` raises when that
is not 0.  A machine without ``nvcc`` raises here: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("attention.cu", "encoder_mlp.cu", "self_attention.cu",
           "cross_attention.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libwhisper_tpu_torch.so"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's usual place

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argument types (every pointer and the stream as c_void_p)
SIGNATURES = {
    # q, k, v, out, batch*heads, T, stream
    "wt_fused_attention": [_P, _P, _P, _P, _I, _I, _P],
    # x, ln_s, ln_b, w1, b1, w2, b2, out, rows, d, f, stream
    "wt_fused_encoder_mlp": [_P] * 8 + [_I, _I, _I, _P],
    # q, k_new, v_new, k_cache, v_cache, pad_count, out,
    # batch, heads, S, layer, pos, stream
    "wt_self_attend_step": [_P] * 7 + [_I] * 5 + [_P],
    # q8, qk_scale, v_scale, k8, v8, out, batch, heads, S, layer,
    # s_valid, stream
    "wt_cross_attend_step": [_P] * 6 + [_I] * 5 + [_P],
}

_lib = None          # the loaded library (one per process)
build_seconds = None  # wall time of the build in this process, if it ran


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    cands += [shutil.which("nvcc"), DEFAULT_NVCC]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the CUDA kernels of "
        "whisper_tpu_torch are compiled from csrc/ at first use")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def build(extra_flags=()) -> Path:
    """Compile ``csrc/*.cu`` into the shared library (each source in
    parallel, then one link) unless a build of these sources exists."""
    global build_seconds
    nvcc = _nvcc()
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.is_file():
        return lib_path
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, s.replace(".cu", ".o")) for s in SOURCES]
        cmds = [[nvcc, *NVCC_FLAGS, *extra_flags, "-I", str(CSRC), "-c",
                 str(CSRC / s), "-o", o] for s, o in zip(SOURCES, objs)]
        with ThreadPoolExecutor(len(cmds)) as pool:
            logs = list(pool.map(_run, cmds))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        _run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
              "-o", tmp_lib, *objs])
        os.replace(tmp_lib, lib_path)
    build_seconds = time.perf_counter() - t0
    log = "".join(logs).strip()
    if log:
        (out_dir / "nvcc.log").write_text(log + "\n")
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel's launch reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, for a kernel launch.

    The library carries its own CUDA runtime, whose current device is card
    0, so a tensor on another card raises instead of launching there."""
    import torch

    if device.index not in (None, 0):
        raise NotImplementedError(
            f"kernels launch on cuda:0 only, got {device}: more cards are "
            "ROADMAP queue 1 item 12")
    return torch.cuda.current_stream(device).cuda_stream
