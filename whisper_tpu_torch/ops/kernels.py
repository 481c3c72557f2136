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
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("attention.cu", "encoder_mlp.cu", "self_attention.cu",
           "cross_attention.cu", "cross_attention_dequant.cu", "log_mel.cu",
           "self_attention_int8.cu", "encoder_block.cu", "decoder_mlp.cu",
           "cross_attention_multi.cu", "decoder_self_block.cu",
           "decoder_cross_block.cu", "launch_floor.cu", "graph_cond.cu",
           "gumbel_pick.cu")
HEADERS = ("common.cuh", "hopper.cuh", "encoder_ffn.cuh", "gemm_sm90.cuh",
           "cross_attention.cuh", "decoder_block.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "libwhisper_tpu_torch.so"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"  # the CUDA toolkit's usual place

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F = ctypes.c_longlong, ctypes.c_float
# entry point -> argument types (every pointer and the stream as c_void_p)
SIGNATURES = {
    # q, k, v, out, batch*heads, T, stream
    "wt_fused_attention": [_P, _P, _P, _P, _I, _I, _P],
    # x, ln_s, ln_b, w1, b1, w2, b2, r scratch, h scratch, out, rows, d, f,
    # stream
    "wt_fused_encoder_mlp": [_P] * 10 + [_I, _I, _I, _P],
    # q, k_new, v_new, k_cache, v_cache, pad_count (or null), out,
    # batch, heads, S, layer, pos, pos on the device (or null), stream
    "wt_self_attend_step": [_P] * 7 + [_I] * 5 + [_P, _P],
    # q, k_scale, v_scale, k8, v8, out, batch, heads, S, layer, s_valid,
    # stream (both)
    "wt_cross_attend_step": [_P] * 6 + [_I] * 5 + [_P],
    "wt_cross_attend_step_dequant": [_P] * 6 + [_I] * 5 + [_P],
    # audio, is_int16, n_samples, twiddles, window, bands, weights, out,
    # tile maxima scratch, n_frames, valid_frames, n_mels, int16 scale,
    # normalize, stream
    "wt_log_mel": [_P, _I, _L] + [_P] * 6 + [_I, _I, _I, _F, _I, _P],
    # q, k_new, v_new, k_cache, v_cache, k_scale, v_scale, pad_count (or
    # null), out, batch, heads, S, layer, pos, pos on the device (or null),
    # stream
    "wt_self_attend_step_int8": [_P] * 9 + [_I] * 5 + [_P, _P],
    # x, ln_s, ln_b, w_qkv, b_qkv, r scratch, out, rows, d, columns, stream
    "wt_fused_ln_qkv": [_P] * 7 + [_I, _I, _I, _P],
    # x, ctx, o_w, o_b, ln_s, ln_b, w1, b1, w2, b2, y32 scratch, r scratch,
    # h scratch, out, rows, d, f, stream
    "wt_fused_out_mlp": [_P] * 14 + [_I, _I, _I, _P],
    # x, ln, w1, b1, w2, b2, h scratch, out, batch, d, f, stream
    "wt_decoder_mlp": [_P] * 8 + [_I, _I, _I, _P],
    # q, k_scale, v_scale, k8, v8, out, batch, T, heads, S, layer, s_valid,
    # stream (both)
    "wt_cross_attend_multi": [_P] * 6 + [_I] * 6 + [_P],
    "wt_cross_attend_multi_dequant": [_P] * 6 + [_I] * 6 + [_P],
    # x, ln, qkv_w, qkv_b, o_w, o_b, cache_k, cache_v, q scratch, ctx
    # scratch, out, batch, d, heads, S, pos, pos on the device (or null),
    # stream
    "wt_decoder_self_block": [_P] * 11 + [_I] * 5 + [_P, _P],
    # x, ln, q_w, q_b, o_w, o_b, cross_k, cross_v, q scratch, ctx scratch,
    # out, batch, d, heads, T, stream
    "wt_decoder_cross_block": [_P] * 11 + [_I] * 4 + [_P],
    # stream: an empty kernel
    "wt_launch_floor": [_P],
    # counter ([1] int64), stream: a kernel that adds one to the counter
    "wt_launch_count": [_P, _P],
    # the card of the next launches (the library runtime's current device)
    "wt_set_device": [_I],
    # inside a graph capture on the parent stream: a conditional (while)
    # node on "trips < bound and some of n done flags is false", its body
    # captured from the body stream; done, n, trips, bound, parent stream,
    # body stream, capture mode, where the node's handle is written
    "wt_while_node_begin": [_P, _I, _P, _L, _P, _P, _I, _P],
    # the handle, done, n, trips, bound, body stream, whether to queue the
    # condition as the body's last node (0: the body's tail set it), where
    # the body's device operations are written (or null): the end of the
    # body's capture
    "wt_while_node_end": [ctypes.c_ulonglong, _P, _I, _P, _L, _P, _I, _P],
    # stream, where the type is written: inside a capture on the stream,
    # the first node captured that a while node's body may not hold (-1:
    # none)
    "wt_capture_bad_node": [_P, _P],
    # nxt, lp (or null), done, buf, last, sum_lp (or null), n_tok (or
    # null), pos, step, rows, cols, eot, the while node's handle, whether
    # to set it, the node's bound, stream: the greedy step's tail
    "wt_loop_tail": [_P] * 9 + [_I, _I, _L, ctypes.c_ulonglong, _I, _L, _P],
    # done, n, trips, stream, launches: inside a capture, the condition
    # kernel alone, each launch setting 0, then a while node that runs no
    # iteration (timing)
    "wt_condition_kernels": [_P, _I, _P, _P, _I],
    # logits, temperature, key, step, tok, uniforms (or null), scores (or
    # null), workspace, rows, vocab, row0, stream
    "wt_gumbel_pick": [_P] * 8 + [_I, _I, _I, _P],
    # rows, vocab: the groups of four ids each block of the pick takes
    "wt_gumbel_pick_groups_per_block": [_I, _I],
}

_lib = None          # the loaded library (one per process)
_lib_lock = threading.Lock()  # the CLI's prefetch thread may load it too
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
    with _lib_lock:
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
    """PyTorch's current stream on ``device``, for a kernel launch, after
    making ``device`` the library's current card.

    The library carries its own CUDA runtime, whose current device is card
    0 until told otherwise: ``wt_set_device`` gives it the tensor's card
    (PyTorch's current card for a bare "cuda") before each launch, so a
    rank of a mesh on ``cuda:N`` launches there."""
    import torch

    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    check(library().wt_set_device(index), f"wt_set_device({index})")
    return torch.cuda.current_stream(device).cuda_stream
