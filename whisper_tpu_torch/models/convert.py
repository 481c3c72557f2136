"""Parameter initialization, HF-checkpoint conversion and the on-disk
format (port of ``whisper_tpu.models.convert``).

``init_params`` builds the stacked-layer parameter tree in numpy from
``default_rng(seed)``, leaf for leaf identical to the JAX package's, so
that both packages start from the same weights.
``params_from_hf_state_dict`` maps a transformers Whisper state dict
(torch tensors or numpy arrays) onto that tree, and ``convert_hf_model_dir``
turns an HF checkpoint dir into a model dir.  ``save_params`` and
``load_params`` write and read the JAX package's format
(``params.safetensors`` with stacked [L, ...] leaves and ``QTensor``
q8/scale pairs, plus ``config.json``) with numpy alone
(``write_safetensors``, ``read_safetensors``): the card's machine has no
``safetensors`` package, and no jax.  The files are those the JAX
package's ``save_params`` writes, byte for byte, and each package loads the
other's.  ``save_params_orbax`` and ``load_params_orbax`` are not ported
(ROADMAP "Not to port").  ``params_from_numpy``
turns such a tree (numpy arrays, or the JAX package's tree with its
arrays read back as numpy; ``QTensor`` pairs included) into the port's
torch tree with ``cast_params`` semantics: float leaves cast to the
compute dtype, int8 ``q`` and fp32 ``s`` kept.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from whisper_tpu_torch.models.registry import WhisperDims
from whisper_tpu_torch.models.whisper import sinusoid_position_embedding
from whisper_tpu_torch.variants.quant import QTensor


def init_params(dims: WhisperDims, seed: int = 0) -> Dict:
    """Random-init float32 numpy params with the exact tree structure of a
    converted checkpoint (small scale keeps fp32 greedy well-behaved)."""
    rng = np.random.default_rng(seed)
    d, f = dims.d_model, dims.d_ffn

    def w(*shape, scale=0.02):
        return rng.normal(0.0, scale, size=shape).astype(np.float32)

    def zeros(*shape):
        return np.zeros(shape, dtype=np.float32)

    def ones(*shape):
        return np.ones(shape, dtype=np.float32)

    def attn(le, prefix=""):
        return {
            f"{prefix}q_w": w(le, d, d), f"{prefix}q_b": zeros(le, d),
            f"{prefix}k_w": w(le, d, d),
            f"{prefix}v_w": w(le, d, d), f"{prefix}v_b": zeros(le, d),
            f"{prefix}o_w": w(le, d, d), f"{prefix}o_b": zeros(le, d),
        }

    le, ld = dims.encoder_layers, dims.decoder_layers
    enc_blocks = {
        "attn_ln_s": ones(le, d), "attn_ln_b": zeros(le, d),
        **attn(le),
        "mlp_ln_s": ones(le, d), "mlp_ln_b": zeros(le, d),
        "fc1_w": w(le, d, f), "fc1_b": zeros(le, f),
        "fc2_w": w(le, f, d), "fc2_b": zeros(le, d),
    }
    dec_blocks = {
        "ln_s": ones(ld, d), "ln_b": zeros(ld, d),
        **attn(ld),
        "x_ln_s": ones(ld, d), "x_ln_b": zeros(ld, d),
        "xq_w": w(ld, d, d), "xq_b": zeros(ld, d),
        "xk_w": w(ld, d, d),
        "xv_w": w(ld, d, d), "xv_b": zeros(ld, d),
        "xo_w": w(ld, d, d), "xo_b": zeros(ld, d),
        "mlp_ln_s": ones(ld, d), "mlp_ln_b": zeros(ld, d),
        "fc1_w": w(ld, d, f), "fc1_b": zeros(ld, f),
        "fc2_w": w(ld, f, d), "fc2_b": zeros(ld, d),
    }
    return {
        "encoder": {
            "conv1_w": w(3, dims.n_mels, d), "conv1_b": zeros(d),
            "conv2_w": w(3, d, d), "conv2_b": zeros(d),
            "pos_embed": sinusoid_position_embedding(
                dims.max_source_positions, d),
            "blocks": enc_blocks,
            "ln_f_s": ones(d), "ln_f_b": zeros(d),
        },
        "decoder": {
            "tok_emb": w(dims.vocab_size, d),
            "pos_embed": w(dims.max_target_positions, d),
            "blocks": dec_blocks,
            "ln_f_s": ones(d), "ln_f_b": zeros(d),
        },
    }


PARAMS_FILE = "params.safetensors"
CONFIG_FILE = "config.json"

# safetensors dtype tags -> numpy dtypes (BF16 is widened to float32 below)
_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
              "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1",
              "BOOL": "?"}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: array} of a safetensors file, read with numpy: an 8-byte
    little-endian header length, a JSON header of dtype, shape and data
    offsets, then the raw little-endian bytes.  BF16 tensors come back as
    float32 (exact)."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    (n,) = struct.unpack("<Q", bytes(raw[:8]))
    header = json.loads(bytes(raw[8:8 + n]))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        buf = raw[base + start: base + end]
        if info["dtype"] == "BF16":
            arr = (buf.view("<u2").astype(np.uint32) << 16).view(np.float32)
        else:
            arr = buf.view(_ST_DTYPES[info["dtype"]]).copy()
        out[name] = arr.reshape(info["shape"])
    return out


# Order of the data section: dtypes in the safetensors library's order,
# the last first, then names (the library's ``save_file``), so that the
# bytes are the JAX package's.
_ST_ORDER = ("BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32", "U32",
             "F32", "F64", "I64", "U64")
_NP_TAGS = {np.dtype(v): k for k, v in _ST_DTYPES.items()}


def write_safetensors(tensors: Dict[str, np.ndarray], path: str) -> None:
    """Write {name: array} as a safetensors file with numpy: an 8-byte
    little-endian header length, a JSON header of dtype, shape and data
    offsets (padded with spaces to a multiple of 8 bytes), then each
    tensor's little-endian bytes.  Every array goes through
    ``np.ascontiguousarray`` first: a non-contiguous array's raw buffer is
    not its values (numpy 2 and safetensors 0.8 wrote such arrays scrambled,
    ``np.stack`` over transposed views)."""
    arrays = {}
    for name, v in tensors.items():
        a = np.ascontiguousarray(v)
        if a.dtype not in _NP_TAGS:
            raise TypeError(f"{name}: dtype {a.dtype} has no safetensors tag")
        arrays[name] = a
    order = sorted(arrays, key=lambda k: (
        -_ST_ORDER.index(_NP_TAGS[arrays[k].dtype]), k))
    header, offset = {}, 0
    for name in order:
        a = arrays[name]
        header[name] = {"dtype": _NP_TAGS[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for name in order:
            f.write(arrays[name].tobytes())


def _np(x) -> np.ndarray:
    """torch tensor / numpy array -> float32 numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().float().numpy()
    return np.asarray(x, dtype=np.float32)


def params_from_hf_state_dict(sd: Dict[str, Any], dims: WhisperDims) -> Dict:
    """Convert a transformers WhisperForConditionalGeneration state dict
    (torch tensors or numpy arrays) into the stacked-layer numpy tree:
    torch ``Linear`` weights [out, in] -> [in, out], ``Conv1d`` [out, in,
    width] -> [width, in, out], per-layer tensors stacked on a leading
    axis; float32, value for value the JAX package's."""
    sd = {k.removeprefix("model."): v for k, v in sd.items()}

    def lin_w(name):  # torch Linear stores [out, in]; the tree [in, out]
        return _np(sd[name]).T

    def stack(fmt, n, fn):
        return np.stack([fn(fmt.format(i)) for i in range(n)])

    le, ld = dims.encoder_layers, dims.decoder_layers

    def attn_block(side, n, attr):
        base = f"{side}.layers.{{}}.{attr}"
        return {
            "q_w": stack(base + ".q_proj.weight", n, lin_w),
            "q_b": stack(base + ".q_proj.bias", n, lambda k: _np(sd[k])),
            "k_w": stack(base + ".k_proj.weight", n, lin_w),
            "v_w": stack(base + ".v_proj.weight", n, lin_w),
            "v_b": stack(base + ".v_proj.bias", n, lambda k: _np(sd[k])),
            "o_w": stack(base + ".out_proj.weight", n, lin_w),
            "o_b": stack(base + ".out_proj.bias", n, lambda k: _np(sd[k])),
        }

    def vec(fmt, n):
        return stack(fmt, n, lambda k: _np(sd[k]))

    enc_blocks = {
        "attn_ln_s": vec("encoder.layers.{}.self_attn_layer_norm.weight", le),
        "attn_ln_b": vec("encoder.layers.{}.self_attn_layer_norm.bias", le),
        **attn_block("encoder", le, "self_attn"),
        "mlp_ln_s": vec("encoder.layers.{}.final_layer_norm.weight", le),
        "mlp_ln_b": vec("encoder.layers.{}.final_layer_norm.bias", le),
        "fc1_w": stack("encoder.layers.{}.fc1.weight", le, lin_w),
        "fc1_b": vec("encoder.layers.{}.fc1.bias", le),
        "fc2_w": stack("encoder.layers.{}.fc2.weight", le, lin_w),
        "fc2_b": vec("encoder.layers.{}.fc2.bias", le),
    }
    dec_blocks = {
        "ln_s": vec("decoder.layers.{}.self_attn_layer_norm.weight", ld),
        "ln_b": vec("decoder.layers.{}.self_attn_layer_norm.bias", ld),
        **attn_block("decoder", ld, "self_attn"),
        "x_ln_s": vec("decoder.layers.{}.encoder_attn_layer_norm.weight", ld),
        "x_ln_b": vec("decoder.layers.{}.encoder_attn_layer_norm.bias", ld),
        **{"x" + k: v
           for k, v in attn_block("decoder", ld, "encoder_attn").items()},
        "mlp_ln_s": vec("decoder.layers.{}.final_layer_norm.weight", ld),
        "mlp_ln_b": vec("decoder.layers.{}.final_layer_norm.bias", ld),
        "fc1_w": stack("decoder.layers.{}.fc1.weight", ld, lin_w),
        "fc1_b": vec("decoder.layers.{}.fc1.bias", ld),
        "fc2_w": stack("decoder.layers.{}.fc2.weight", ld, lin_w),
        "fc2_b": vec("decoder.layers.{}.fc2.bias", ld),
    }
    return {
        "encoder": {
            "conv1_w": _np(sd["encoder.conv1.weight"]).transpose(2, 1, 0),
            "conv1_b": _np(sd["encoder.conv1.bias"]),
            "conv2_w": _np(sd["encoder.conv2.weight"]).transpose(2, 1, 0),
            "conv2_b": _np(sd["encoder.conv2.bias"]),
            "pos_embed": _np(sd["encoder.embed_positions.weight"]),
            "blocks": enc_blocks,
            "ln_f_s": _np(sd["encoder.layer_norm.weight"]),
            "ln_f_b": _np(sd["encoder.layer_norm.bias"]),
        },
        "decoder": {
            "tok_emb": _np(sd["decoder.embed_tokens.weight"]),
            "pos_embed": _np(sd["decoder.embed_positions.weight"]),
            "blocks": dec_blocks,
            "ln_f_s": _np(sd["decoder.layer_norm.weight"]),
            "ln_f_b": _np(sd["decoder.layer_norm.bias"]),
        },
    }


def _flatten(params: Dict, prefix="") -> Dict[str, np.ndarray]:
    """Nested dict -> '/'-joined keys; a ``QTensor`` -> ``<key>.q8`` and
    ``<key>.scale``."""
    out = {}
    for k, v in params.items():
        key = f"{prefix}{k}"
        if isinstance(v, QTensor):
            out[key + ".q8"] = np.asarray(v.q)
            out[key + ".scale"] = np.asarray(v.s)
        elif isinstance(v, dict):
            out.update(_flatten(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    """'/'-joined keys -> nested dict; ``<key>.q8``/``<key>.scale`` pairs ->
    ``QTensor`` (the JAX package's ``_flatten`` inverted)."""
    out: Dict = {}
    pending_q: Dict[str, Dict[str, np.ndarray]] = {}
    for key, v in flat.items():
        if key.endswith(".q8") or key.endswith(".scale"):
            base, _, kind = key.rpartition(".")
            pending_q.setdefault(base, {})[kind] = v
            continue
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    for base, parts_q in pending_q.items():
        parts = base.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = QTensor(q=parts_q["q8"], s=parts_q["scale"])
    return out


def load_params(model_dir: str) -> Tuple[Dict, WhisperDims]:
    """(numpy parameter tree, dims) of a model dir in the JAX package's
    ``save_params`` format."""
    flat = read_safetensors(os.path.join(model_dir, PARAMS_FILE))
    with open(os.path.join(model_dir, CONFIG_FILE)) as f:
        cfg = json.load(f)
    return _unflatten(flat), WhisperDims(**cfg["whisper_tpu_dims"])


def save_params(params: Dict, dims: WhisperDims, model_dir: str,
                extra_config: Dict | None = None) -> None:
    """Write ``params.safetensors`` (every leaf contiguous, by
    ``write_safetensors``) and ``config.json`` ({"whisper_tpu_dims": ...}
    plus ``extra_config``) into ``model_dir``: the JAX package's
    ``save_params`` files."""
    os.makedirs(model_dir, exist_ok=True)
    write_safetensors(_flatten(params), os.path.join(model_dir, PARAMS_FILE))
    cfg = {"whisper_tpu_dims": dims.to_dict()}
    if extra_config:
        cfg.update(extra_config)
    with open(os.path.join(model_dir, CONFIG_FILE), "w") as f:
        json.dump(cfg, f, indent=2)


def convert_hf_model_dir(hf_dir: str, out_dir: str,
                         model_id: str | None = None) -> None:
    """Convert an HF checkpoint dir (``config.json`` + ``*.safetensors``)
    into a model dir, reading the weights with ``read_safetensors``;
    ``tokenizer.json`` and ``generation_config.json`` are copied beside
    them when present."""
    import shutil

    from whisper_tpu_torch.models.registry import dims_from_hf_config

    with open(os.path.join(hf_dir, "config.json")) as f:
        dims = dims_from_hf_config(json.load(f))
    sd = {}
    for name in sorted(os.listdir(hf_dir)):
        if name.endswith(".safetensors"):
            sd.update(read_safetensors(os.path.join(hf_dir, name)))
    if not sd:
        raise FileNotFoundError(f"No .safetensors weights found in {hf_dir}")
    save_params(params_from_hf_state_dict(sd, dims), dims, out_dir,
                extra_config={"source": hf_dir, "model_id": model_id})
    for sidecar in ("tokenizer.json", "generation_config.json"):
        src = os.path.join(hf_dir, sidecar)
        if os.path.isfile(src):
            shutil.copy(src, os.path.join(out_dir, sidecar))


def params_from_numpy(tree, device, dtype: torch.dtype) -> Dict:
    """numpy (or array-like) tree -> torch tree on ``device``: float leaves
    cast to ``dtype``; any pair with ``q``/``s`` fields (this package's or
    the JAX package's ``QTensor``) becomes a ``QTensor`` of int8 ``q`` and
    fp32 ``s``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in tree.items()}
    if hasattr(tree, "q") and hasattr(tree, "s"):
        return QTensor(
            q=torch.from_numpy(np.array(tree.q, dtype=np.int8)).to(device),
            s=torch.from_numpy(np.array(tree.s, dtype=np.float32)).to(device))
    arr = np.array(tree, dtype=np.float32)  # a writable copy
    return torch.from_numpy(arr).to(device=device, dtype=dtype)
