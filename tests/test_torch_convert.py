"""The port's checkpoint converter, safetensors writer and int8 model-dir
quantizer against the JAX package's (CPU).

A randomly initialised ``transformers`` Whisper of toy dims with an
asymmetric depth (tests/test_convert_roundtrip.py's config), built in the
test, gives the state dict.  The port's tree equals the JAX package's leaf
for leaf (equal values); the files the port writes equal the JAX
package's byte for byte and each package loads the other's value for
value; the port's encoder and prefill logits on the converted weights are
within 3e-4 of ``transformers``' (the JAX test's tolerance).  Skips
without ``transformers``, as the JAX test does.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from safetensors.numpy import save_file  # noqa: E402

from whisper_tpu.models import convert as jconvert  # noqa: E402
from whisper_tpu.models.convert_cli import main as jax_convert_cli  # noqa: E402
from whisper_tpu.variants.quantize_int8 import (  # noqa: E402
    quantize_model_dir as jax_quantize_model_dir,
)
from whisper_tpu_torch.models import convert  # noqa: E402
from whisper_tpu_torch.models import whisper as tw  # noqa: E402
from whisper_tpu_torch.models.convert_cli import main as convert_cli  # noqa: E402
from whisper_tpu_torch.models.registry import (  # noqa: E402
    dims_from_hf_config,
    get_dims,
)
from whisper_tpu_torch.variants import quant  # noqa: E402
from whisper_tpu_torch.variants.quantize_int8 import (  # noqa: E402
    quantize_model_dir,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def turbo_like():
    """Deep encoder, 2-layer decoder (tests/test_convert_roundtrip.py)."""
    cfg = transformers.WhisperConfig(
        vocab_size=400, num_mel_bins=80, d_model=64,
        encoder_layers=4, encoder_attention_heads=4,
        decoder_layers=2, decoder_attention_heads=4,
        encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=100, max_target_positions=48,
        pad_token_id=0, bos_token_id=1, eos_token_id=2,
        decoder_start_token_id=3,
    )
    torch.manual_seed(5)
    model = transformers.WhisperForConditionalGeneration(cfg).eval()
    return model, dims_from_hf_config(cfg)


@pytest.fixture(scope="module")
def hf_dir(turbo_like, tmp_path_factory):
    d = tmp_path_factory.mktemp("hf")
    turbo_like[0].save_pretrained(str(d), safe_serialization=True)
    (d / "tokenizer.json").write_text('{"model": {"vocab": {}}}')
    (d / "generation_config.json").write_text('{"suppress_tokens": [5]}')
    return d


def _leaves(tree, prefix=""):
    """{path: numpy array} of a tree, QTensor pairs as two leaves."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        elif hasattr(v, "q") and hasattr(v, "s"):
            out[f"{prefix}{k}.q8"] = np.asarray(v.q)
            out[f"{prefix}{k}.scale"] = np.asarray(v.s)
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_params_from_hf_state_dict_equals_jax(turbo_like, kind):
    """The state dict as torch tensors or as numpy arrays: the JAX
    package's tree, leaf for leaf, every leaf float32."""
    model, dims = turbo_like
    sd = model.state_dict()
    want = jconvert.params_from_hf_state_dict(sd, dims)
    if kind == "numpy":
        sd = {k: v.numpy() for k, v in sd.items()}
    got = convert.params_from_hf_state_dict(sd, dims)
    _assert_trees_equal(got, want)
    assert all(v.dtype == np.float32 for v in _leaves(got).values())


def test_converted_weights_give_transformers_logits(turbo_like):
    """The port's encoder and prefill logits on the converted tree, fp32 on
    the CPU, within 3e-4 of ``transformers``'."""
    model, dims = turbo_like
    params = convert.params_from_numpy(
        convert.params_from_hf_state_dict(model.state_dict(), dims), "cpu",
        torch.float32)
    rng = np.random.default_rng(0)
    mel = rng.normal(0, 1, (1, 80, 200)).astype(np.float32)
    toks = np.array([[3, 10, 20]], dtype=np.int64)
    with torch.no_grad():
        out = model(input_features=torch.from_numpy(mel),
                    decoder_input_ids=torch.from_numpy(toks),
                    output_hidden_states=True)
        enc = tw.encoder_apply(params, dims, torch.from_numpy(mel))
        logits, _ = tw.decoder_prefill(params, dims, torch.from_numpy(toks),
                                       enc, max_len=8)
    np.testing.assert_allclose(enc.numpy(),
                               out.encoder_last_hidden_state.numpy(),
                               atol=3e-4, rtol=0)
    np.testing.assert_allclose(logits.numpy(), out.logits.numpy(), atol=3e-4,
                               rtol=0)


def test_convert_cli_int8_files_equal_the_jax_tools(hf_dir, tmp_path):
    """``convert_cli --int8`` from a ``save_pretrained`` dir: the model dir
    and its int8 copy hold the JAX tool's params.safetensors byte for
    byte, its config (less the source path of the int8 copy) and its
    sidecars; both packages' ``load_params`` read both packages' files
    value for value."""
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    argv = ["--hf-dir", str(hf_dir), "--model-id", "test/turbo-like",
            "--int8"]
    assert convert_cli(argv + ["--out-dir", str(ours)]) == 0
    assert jax_convert_cli(argv + ["--out-dir", str(theirs)]) == 0
    for suffix in ("", "-int8"):
        a, b = f"{ours}{suffix}", f"{theirs}{suffix}"
        assert open(f"{a}/params.safetensors", "rb").read() == \
            open(f"{b}/params.safetensors", "rb").read()
        ca, cb = (json.load(open(f"{d}/config.json")) for d in (a, b))
        ca.pop("source"), cb.pop("source")
        assert ca == cb
        for side in ("tokenizer.json", "generation_config.json"):
            assert open(f"{a}/{side}").read() == open(f"{b}/{side}").read()
        want, dims = jconvert.load_params(b)
        for reader in (convert.load_params, jconvert.load_params):
            for d in (a, b):
                got, got_dims = reader(d)
                assert got_dims.to_dict() == dims.to_dict()
                _assert_trees_equal(got, want)
    assert quant.is_quantized(convert.load_params(f"{ours}-int8")[0])
    meta = json.load(open(f"{ours}-int8/optimization_metadata.json"))
    jmeta = json.load(open(f"{theirs}-int8/optimization_metadata.json"))
    assert sorted(meta) == sorted(jmeta)
    assert meta["variant"] == jmeta["variant"] == "x4"
    assert meta["framework"] == "whisper_tpu_torch"


def test_a_transposed_view_leaf_survives_the_disk_roundtrip(tmp_path):
    """``np.stack`` over transposed views gives a non-contiguous array; its
    raw buffer is not its values.  Written by the port, it reads back
    equal in both packages."""
    dims = get_dims("test/whisper-nano")
    params = convert.init_params(dims, seed=3)
    blocks = params["encoder"]["blocks"]
    blocks["q_w"] = np.stack([x.T for x in blocks["q_w"]])
    blocks["fc1_w"] = blocks["fc1_w"].transpose(0, 2, 1).copy().transpose(
        0, 2, 1)
    params["decoder"]["tok_emb"] = params["decoder"]["tok_emb"][:, ::-1]
    assert not blocks["fc1_w"].flags.c_contiguous
    assert not params["decoder"]["tok_emb"].flags.c_contiguous
    convert.save_params(params, dims, str(tmp_path / "m"))
    for reader in (convert.load_params, jconvert.load_params):
        got, _ = reader(str(tmp_path / "m"))
        _assert_trees_equal(got, params)


def test_save_params_bytes_equal_jax(tmp_path):
    """``init_params`` (nano) and its int8 tree (each package's
    ``quantize_params``) through both packages' ``save_params``: the same
    files, byte for byte."""
    from whisper_tpu.variants.quant import quantize_params as jax_quantize

    dims = get_dims("test/whisper-nano")
    params = convert.init_params(dims, seed=4)
    for name, ours, theirs in (
            ("f32", params, params),
            ("int8", quant.quantize_params(params), jax_quantize(params))):
        extra = {"model_id": "test/whisper-nano"}
        convert.save_params(ours, dims, str(tmp_path / f"p-{name}"), extra)
        jconvert.save_params(theirs, dims, str(tmp_path / f"j-{name}"), extra)
        for f in ("params.safetensors", "config.json"):
            assert (tmp_path / f"p-{name}" / f).read_bytes() == \
                (tmp_path / f"j-{name}" / f).read_bytes()


def test_quantize_model_dir_bitwise_equal_to_jax(tmp_path):
    """The int8 quantizer over one model dir: the JAX tool's
    params.safetensors byte for byte, its config less the source path, and
    its metadata keys."""
    dims = get_dims("test/whisper-nano")
    src = str(tmp_path / "m")
    convert.save_params(convert.init_params(dims, seed=6), dims, src,
                        {"model_id": "test/whisper-nano"})
    ours = quantize_model_dir(src, str(tmp_path / "port-int8"))
    theirs = jax_quantize_model_dir(src, str(tmp_path / "jax-int8"))
    assert open(f"{ours}/params.safetensors", "rb").read() == \
        open(f"{theirs}/params.safetensors", "rb").read()
    assert json.load(open(f"{ours}/config.json")) == \
        json.load(open(f"{theirs}/config.json"))
    meta = json.load(open(f"{ours}/optimization_metadata.json"))
    jmeta = json.load(open(f"{theirs}/optimization_metadata.json"))
    assert sorted(meta) == sorted(jmeta)
    assert meta["base_model_id"] == jmeta["base_model_id"]
    assert quantize_model_dir(src) == src + "-int8"


WRITER_CASES = {
    "f32_i8": {"b": np.arange(6, dtype=np.float32).reshape(2, 3),
               "a": np.array([-3, 7], np.int8),
               "c/x.scale": np.ones((1, 3), np.float32)},
    "every_dtype": {n: np.arange(4).astype(t) for n, t in (
        ("z", np.float64), ("y", np.int64), ("x", np.int32),
        ("w", np.float16), ("v", np.int16), ("u", np.uint8),
        ("t", np.bool_), ("s", np.float32), ("r", np.int8))},
    "non_contiguous": {"m": np.arange(12, dtype=np.float32).reshape(3, 4).T,
                       "n": np.zeros((0, 3), np.float32),
                       "o": np.float32(2.5)},
}


@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_write_safetensors_equals_the_library(case, tmp_path):
    """The numpy writer against ``safetensors.numpy.save_file`` (on
    contiguous copies): the same bytes; ``read_safetensors`` reads the
    values back."""
    tensors = WRITER_CASES[case]
    convert.write_safetensors(tensors, str(tmp_path / "ours"))
    save_file({k: np.ascontiguousarray(v) for k, v in tensors.items()},
              str(tmp_path / "lib"))
    assert (tmp_path / "ours").read_bytes() == (tmp_path / "lib").read_bytes()
    back = convert.read_safetensors(str(tmp_path / "ours"))
    for k, v in tensors.items():
        assert back[k].dtype == np.asarray(v).dtype
        np.testing.assert_array_equal(back[k], v)


def test_converter_needs_neither_jax_nor_safetensors(hf_dir, tmp_path):
    """The converter CLI in a fresh process with ``jax`` and
    ``safetensors`` made unimportable: rc 0, the JAX package can read what
    it wrote."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    block = tmp_path / "block"
    block.mkdir()
    for mod in ("jax", "safetensors", "transformers"):
        (block / mod).mkdir()
        (block / mod / "__init__.py").write_text(
            f"raise ImportError('{mod} is blocked')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = f"{block}{os.pathsep}{repo}"
    proc = subprocess.run(
        [sys.executable, "-m", "whisper_tpu_torch.models.convert_cli",
         "--hf-dir", str(hf_dir), "--out-dir", str(tmp_path / "m"), "--int8"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got, _ = jconvert.load_params(str(tmp_path / "m-int8"))
    assert quant.is_quantized(convert.load_params(str(tmp_path / "m-int8"))[0])
    assert "blocks" in got["decoder"]
