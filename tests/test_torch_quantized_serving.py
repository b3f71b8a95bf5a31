"""Quantized-weight serving: the port against the JAX package on the CPU.

JAX ``quantize_params`` at bits 4 and 8 over a tiny DS model (f32, weights
perturbed from their init values), carried across by ``from_jax_params``,
must give JAX's prefill logits, JAX's greedy ``generate`` tokens, and --
through the port's ``PagedServingEngine`` -- the
tokens of JAX ``generate`` (tests/test_engine.py::test_int4_engine_matches_fused_generate).
The port's own ``quantize_params`` equals the JAX-quantized tree byte for
byte; ``load_pretrained_model(load_4bit|load_8bit)`` loads and generates on
the CPU; a quantized tower takes the unfused blocks, as JAX's
``_fused_eligible`` sends it.

Logits: with the W8A8 branch off, the two packages differ only in the order
of f32 sums, and the logits agree to 1e-4 of the largest. With it on (both
packages lowered to ``W8A8_MIN_TOKENS = 16``, as
tests/test_w8a8.py::test_prefill_parity_w8a8_vs_upcast does, so the tiny
prompts engage it) the integer product is bit-equal on equal inputs
(test_torch_quant.py), but a ~1e-7 difference upstream can move one
activation across a rounding boundary of the per-row int8 quantization, and
one such step moves the logits by ~5e-3 of the largest: that comparison
holds them to 2e-2 of the largest logit, 1e-2 relative L2 and the same
argmax. test_w8a8_gap_is_one_step_activation_flips shows it: it records the
int8 activations of every W8A8 product in both packages, finds them equal or
one step apart in a few places, and finds the logits equal to 1e-6 where
none differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from vcoder_tpu import generation as jgen
from vcoder_tpu import quant as jquant
from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.constants import DEPTH_TOKEN_INDEX, IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX
from vcoder_tpu.models import clip as jclip
from vcoder_tpu.models import llama as jllama
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.ops import quant as jq
from vcoder_tpu_torch import generation as tgen
from vcoder_tpu_torch import quant as tquant
from vcoder_tpu_torch.builder import load_pretrained_model
from vcoder_tpu_torch.checkpoint import _map_tensors, from_jax_params, save_pretrained
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.models import clip as tclip
from vcoder_tpu_torch.models import llama as tllama
from vcoder_tpu_torch.models import vcoder as tvcoder
from vcoder_tpu_torch.ops import quant as tq
from vcoder_tpu_torch.ops.quant import QuantizedTensor
from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine
from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer

torch.set_num_threads(1)

IDS = [1, 10, 11, IMAGE_TOKEN_INDEX, DEPTH_TOKEN_INDEX, SEG_TOKEN_INDEX, 12, 16]
MAX_NEW = 6


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(0)
    jp = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32)), jp
    )
    out = dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
               tp=from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    for bits in (4, 8):
        jqp = jquant.quantize_params(jp, bits=bits, destroy=False)
        out[f"jq{bits}"] = jqp
        out[f"tq{bits}"] = from_jax_params(jax.tree.map(np.asarray, jqp), tcfg, device="cpu")
    hw = jcfg.vision.image_size
    out["px"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, hw, hw, 3)))
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def w8a8_at_16(monkeypatch):
    """W8A8 from 16 tokens in both packages, so the tiny prompts engage it."""
    monkeypatch.setattr(jq, "W8A8_MIN_TOKENS", 16)
    monkeypatch.setattr(tq, "W8A8_MIN_TOKENS", 16)


def test_quantized_leaves_carry_across(setup):
    for bits in (4, 8):
        jl = setup[f"jq{bits}"]["lm"]["layers"]["gate_proj"]
        tl = setup[f"tq{bits}"]["lm"]["layers"]["gate_proj"]
        assert isinstance(tl, QuantizedTensor) and tl.bits == bits
        np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
        np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
        assert tuple(tl.shape) == tuple(jl.shape)
        assert setup[f"tq{bits}"]["lm"]["embed_tokens"].dtype == torch.float32


@pytest.mark.parametrize("bits", [4, 8])
def test_prefill_and_decode_logits_match_jax(setup, bits, w8a8_at_16, monkeypatch):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jqp, tqp = setup[f"jq{bits}"], setup[f"tq{bits}"]
    batch = __graft_entry__._example_batch(jcfg, 2)
    B, T = batch["safe_ids"].shape
    assert B * T >= 16
    S = T + 4
    jc = jllama.KVCache.create(jcfg.text, B, S)
    ref, jc = jvcoder.prefill(jqp, jcfg, batch, batch["images"], batch["segs"], batch["depths"],
                              cache=jc, use_vcoder_emb=True, attn_impl="xla")
    arrays = {k: _t(batch[k]).long() for k in ("safe_ids", "vis_idx", "position_ids", "seq_lens")}
    arrays.update({k: _t(batch[k]) for k in ("is_text", "attn_mask")})
    px = [_t(np.asarray(batch[k]).astype(np.float32)) for k in ("images", "segs", "depths")]
    tc = tllama.KVCache.create(tcfg.text, B, S)
    out, tc = tvcoder.prefill(tqp, tcfg, arrays, *px, cache=tc, use_vcoder_emb=True)
    ref = np.asarray(ref)
    _assert_w8a8_logits_close(out.numpy(), ref)
    # With the integer branch off in both packages: 1e-4, and the logits move.
    monkeypatch.setattr(jq, "_W8A8_ENABLED", False)
    tq.set_w8a8(False)
    try:
        off, _ = tvcoder.prefill(tqp, tcfg, arrays, *px, use_vcoder_emb=True)
    finally:
        tq.set_w8a8(True)
    ref_off, _ = jvcoder.prefill(jqp, jcfg, batch, batch["images"], batch["segs"],
                                 batch["depths"], use_vcoder_emb=True, attn_impl="xla")
    ref_off = np.asarray(ref_off)
    np.testing.assert_allclose(off.numpy(), ref_off, rtol=0, atol=1e-4 * np.abs(ref_off).max())
    assert not torch.equal(off, out)
    monkeypatch.setattr(jq, "_W8A8_ENABLED", True)

    tok = np.asarray(jnp.argmax(ref, axis=-1)).astype(np.int32)
    pos = np.asarray(batch["seq_lens"]).astype(np.int32)
    ref1, _ = jvcoder.decode_step(jqp, jcfg, jnp.asarray(tok), jnp.asarray(pos), jc,
                                  attn_impl="xla")
    out1, _ = tvcoder.decode_step(tqp, tcfg, _t(tok).long(), _t(pos).long(), tc)
    _assert_w8a8_logits_close(out1.numpy(), np.asarray(ref1))


def _assert_w8a8_logits_close(out, ref):
    """Logits through the W8A8 branch (see the module docstring)."""
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-2 * np.abs(ref).max())
    assert np.linalg.norm(out - ref) / np.linalg.norm(ref) < 1e-2
    np.testing.assert_array_equal(out.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("bits", [4, 8])
def test_w8a8_gap_is_one_step_activation_flips(setup, bits, cached, w8a8_at_16, monkeypatch):
    """The reason for the loose W8A8 logit limit, shown: the int8 activations
    of the two packages differ by at most one step, in under 0.1% of them
    (an f32 difference of ~1e-7 upstream, e.g. JAX's prefill with a cache
    against without, moves a value across a rounding boundary); where none
    differ, the logits agree to 1e-6 of the largest."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    batch = __graft_entry__._example_batch(jcfg, 2)
    B, T = batch["safe_ids"].shape
    jrec, trec = [], []
    j_w8a8, t_mm = jq._w8a8_matmul, tq._int8.int8_mm_scaled

    def j_recording(x, q, scale):
        x32 = x.astype(jnp.float32)
        xs = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True), 1e-8) / 127.0
        xq = jnp.clip(jnp.round(x32 / xs), -127, 127).astype(jnp.int8)
        jax.debug.callback(lambda a: jrec.append(np.asarray(a)), xq, ordered=True)
        return j_w8a8(x, q, scale)

    def t_recording(a, *args, **kw):
        trec.append(a.numpy().copy())
        return t_mm(a, *args, **kw)

    monkeypatch.setattr(jq, "_w8a8_matmul", j_recording)
    monkeypatch.setattr(tq._int8, "int8_mm_scaled", t_recording)
    jc = jllama.KVCache.create(jcfg.text, B, T + 4) if cached else None
    tc = tllama.KVCache.create(tcfg.text, B, T + 4) if cached else None
    ref, _ = jvcoder.prefill(setup[f"jq{bits}"], jcfg, batch, batch["images"], batch["segs"],
                             batch["depths"], cache=jc, use_vcoder_emb=True, attn_impl="xla")
    jax.effects_barrier()
    arrays = {k: _t(batch[k]).long() for k in ("safe_ids", "vis_idx", "position_ids", "seq_lens")}
    arrays.update({k: _t(batch[k]) for k in ("is_text", "attn_mask")})
    px = [_t(np.asarray(batch[k]).astype(np.float32)) for k in ("images", "segs", "depths")]
    out, _ = tvcoder.prefill(setup[f"tq{bits}"], tcfg, arrays, *px, cache=tc, use_vcoder_emb=True)
    ref, out = np.asarray(ref), out.numpy()

    assert len(jrec) == len(trec) >= 20  # tower, decoder layers and lm_head
    assert [a.shape for a in jrec] == [a.shape for a in trec]
    steps = np.concatenate([np.abs(a.astype(np.int32) - b.astype(np.int32)).ravel()
                            for a, b in zip(jrec, trec)])
    assert steps.max() <= 1
    assert np.count_nonzero(steps) < 1e-3 * steps.size
    if np.count_nonzero(steps) == 0:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
    _assert_w8a8_logits_close(out, ref)


def _jax_tokens(s, bits, **kw):
    px = jnp.asarray(s["px"])
    res = jgen.generate(s[f"jq{bits}"], s["jcfg"], [IDS], px, px, px, max_new_tokens=MAX_NEW,
                        temperature=0.0, attn_impl="xla", **kw)
    return [int(t) for t in res.sequences[0][: int(res.num_generated[0])]]


@pytest.mark.parametrize("bits", [4, 8])
def test_greedy_generate_matches_jax(setup, bits, w8a8_at_16):
    ref = _jax_tokens(setup, bits)
    px = _t(setup["px"])
    res = tgen.generate(setup[f"tq{bits}"], setup["tcfg"], [IDS], px, px, px,
                        max_new_tokens=MAX_NEW)
    assert [int(t) for t in res.sequences[0][: int(res.num_generated[0])]] == ref


@pytest.mark.parametrize("bits", [4, 8])
def test_paged_engine_matches_jax_generate(setup, bits):
    """Mirrors tests/test_engine.py::test_int4_engine_matches_fused_generate
    (paged engine only: the port's slot engine waits); int8 with int8 pools
    too."""
    ref = _jax_tokens(setup, bits, pad_to=512)
    for kv_quant in ((False, True) if bits == 8 else (False,)):
        eng = PagedServingEngine(setup["tcfg"], setup[f"tq{bits}"], max_batch=2, max_len=768,
                                 page_size=16, attn_impl="xla", kv_quant=kv_quant,
                                 device="cpu")
        rid = eng.add_request(IDS, images=setup["px"], segs=setup["px"], depths=setup["px"],
                              max_new_tokens=MAX_NEW)
        assert eng.run()[rid] == ref, f"kv_quant={kv_quant}"


@pytest.mark.parametrize("bits", [4, 8])
def test_port_quantize_params_equals_jax(setup, bits):
    tp = setup["tp"]
    ours = tquant.quantize_params(tp, bits=bits, destroy=False)
    assert isinstance(tp["lm"]["layers"]["q_proj"], torch.Tensor)  # input untouched
    theirs = setup[f"tq{bits}"]
    n_quant = 0
    for path, a, b in _leaves(ours, theirs):
        assert type(a) is type(b), path
        if isinstance(a, QuantizedTensor):
            n_quant += 1
            assert a.bits == b.bits == bits
            assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale), path
        else:
            assert torch.equal(a, b), path
    assert n_quant == 14  # 8 decoder leaves (lm_head included), 6 tower leaves
    # destroy=True replaces the leaves of the caller's containers in place.
    tree = _map_tensors(tp, lambda t: t.clone())
    lm = tree["lm"]
    assert tquant.quantize_params(tree, bits=bits) is tree
    assert isinstance(lm["layers"]["down_proj"], QuantizedTensor)
    assert isinstance(lm["lm_head"], QuantizedTensor)
    assert isinstance(tree["mm_projector"]["w"][0], torch.Tensor)


def _leaves(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            yield from _leaves(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            yield from _leaves(x, y, f"{path}/{i}")
    else:
        yield path, a, b


@pytest.mark.parametrize("bits", [4, 8])
def test_load_pretrained_model_quantized_on_cpu(setup, bits, tmp_path):
    path = str(tmp_path / "vcoder_ds_llava-tiny")
    save_pretrained(path, setup["tp"], setup["tcfg"])
    SimpleTokenizer({"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}).save_pretrained(path)
    kw = {"load_4bit": True} if bits == 4 else {"load_8bit": True}
    _, model, *_ = load_pretrained_model(path, device="cpu", dtype=torch.float32, **kw)
    lp = model.params["lm"]["layers"]
    assert isinstance(lp["q_proj"], QuantizedTensor) and lp["q_proj"].bits == bits
    assert model.device.type == "cpu"
    px = _t(setup["px"])
    res = model.generate([IDS], px, px, px, max_new_tokens=MAX_NEW)
    assert [int(t) for t in res.sequences[0][: int(res.num_generated[0])]] == _jax_tokens(setup, bits)
    with pytest.raises(NotImplementedError):
        load_pretrained_model(path, model_base=path, device="cpu", **kw)


def test_quantized_tower_takes_the_unfused_blocks(setup, monkeypatch):
    """int8 attention weights: the port's clip_encode runs _run_blocks (the
    fused route's repack would receive a quantized tensor) and equals JAX
    clip_encode on the same quantized tree; plain weights keep the fused
    route."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    images = np.random.RandomState(6).randn(3, 28, 28, 3).astype(np.float32)
    fused_calls = []
    real = tclip._run_blocks_fused
    monkeypatch.setattr(tclip, "_run_blocks_fused",
                        lambda *a, **k: fused_calls.append(1) or real(*a, **k))
    jvt, tvt = setup["jq8"]["vision_tower"], setup["tq8"]["vision_tower"]
    assert isinstance(tvt["layers"]["q_proj"], QuantizedTensor)
    ref = np.asarray(jclip.clip_encode(jvt, jcfg.vision, jnp.asarray(images)))
    out = tclip.clip_encode(tvt, tcfg.vision, _t(images))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
    assert not fused_calls
    tclip.clip_encode(setup["tp"]["vision_tower"], tcfg.vision, _t(images))
    assert fused_calls == [1]


def test_init_quantized_params_structure_matches_jax(setup):
    """Sampled directly in quantized form: the tree, the leaf types, shapes
    and dtypes of JAX's quantized model, scales 0.02/qmax, norms ones and
    biases zeros (vcoder_tpu/quant.py::init_quantized_params)."""
    for bits in (4, 8):
        qmax = 7 if bits == 4 else 127
        ttree = tquant.init_quantized_params(setup["tcfg"], bits=bits, dtype=torch.float32,
                                             device="cpu")
        for path, a, b in _leaves(ttree, setup[f"tq{bits}"]):
            assert type(a) is type(b), path
            if isinstance(a, QuantizedTensor):
                assert a.bits == bits and a.q.shape == b.q.shape and a.q.dtype == torch.int8
                assert torch.all(a.scale == np.float32(0.02 / qmax)), path
                vals = tq.unpack_int4(a.q) if bits == 4 else a.q
                assert vals.abs().max() <= qmax and vals.float().std() > qmax / 3, path
            else:
                assert a.shape == b.shape and a.dtype == b.dtype, path
                if "norm" in path or "ln" in path:
                    want = 0.0 if "bias" in path else 1.0
                    assert torch.all(a == want), path
                elif "bias" in path or "/b/" in path:
                    assert torch.all(a == 0), path
                else:
                    assert 0.01 < a.float().std() < 0.03, path
