"""VCoder-DS-13B's geometry on the CPU: the port against the JAX package.

* ``VCoderConfig.standard(t, "13b")`` for every model type, its
  ``to_hf_config()``, and ``from_hf_config`` of the published 13B
  LLaVA-1.5 fields (written here) equal JAX's field by field.
* A narrow model with 13B's head layout (H = KH = 40 at head_dim 8, hidden
  320, intermediate 864, 2 layers, the tiny tower; f32, JAX's init
  perturbed by seeded numpy noise, carried across by ``from_jax_params``):
  greedy ``generate`` equals JAX's; the paged engine over bf16-layout and
  int8 pools, and the int8 and int4 quantized engines, equal JAX's engines
  token for token (as tests/test_torch_paged_engine.py and
  test_torch_quantized_serving.py hold the 7B layout), with
  ``W8A8_MIN_TOKENS`` lowered to 16 in both packages so the prefills take
  the integer product.
* The loader reads a checkpoint file into one buffer and stacks each layer
  on the device it loads onto.
* A tiny-width checkpoint saved as ``vcoder_ds_llava-v1.5-13b`` loads under
  ``load_4bit=True`` in both packages to the same model type, the same
  quantized fields and the same first tokens.

Exact token equality: greedy tokens of two f32 implementations agree unless
two logits tie to ~1e-6 (tests/test_torch_quantized_serving.py explains the
W8A8 branch's one-step activation flips, which these prompts do not meet).
"""

import dataclasses
import json
import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu import builder as jbuilder
from vcoder_tpu import generation as jgen
from vcoder_tpu import quant as jquant
from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.constants import DEPTH_TOKEN_INDEX, IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX
from vcoder_tpu.mm_tokens import get_model_name_from_path as jname
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.ops import quant as jq
from vcoder_tpu.serve import paged_engine as jpe
from vcoder_tpu_torch import builder as tbuilder
from vcoder_tpu_torch import generation as tgen
from vcoder_tpu_torch.checkpoint import from_jax_params, save_pretrained
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.mm_tokens import get_model_name_from_path as tname
from vcoder_tpu_torch.ops import quant as tq
from vcoder_tpu_torch.ops.quant import QuantizedTensor
from vcoder_tpu_torch.serve import paged_engine as tpe
from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer

torch.set_num_threads(1)

MODEL_TYPES = ("llava", "vcoder_llava", "vcoder_ds_llava", "vcoder_it_llava")
DIR_13B = "vcoder_ds_llava-v1.5-13b"
MAX_NEW = 6

# The text fields of the published LLaVA-1.5-13B config.json
# (liuhaotian/llava-v1.5-13b; the VCoder checkpoints are built on it).
PUBLISHED_13B = {
    "architectures": ["LlavaLlamaForCausalLM"],
    "bos_token_id": 1,
    "eos_token_id": 2,
    "hidden_act": "silu",
    "hidden_size": 5120,
    "image_aspect_ratio": "pad",
    "intermediate_size": 13824,
    "max_position_embeddings": 4096,
    "mm_hidden_size": 1024,
    "mm_projector_type": "mlp2x_gelu",
    "mm_use_im_patch_token": False,
    "mm_use_im_start_end": False,
    "mm_vision_select_feature": "patch",
    "mm_vision_select_layer": -2,
    "mm_vision_tower": "openai/clip-vit-large-patch14-336",
    "model_type": "llava",
    "num_attention_heads": 40,
    "num_hidden_layers": 40,
    "num_key_value_heads": 40,
    "pad_token_id": 0,
    "rms_norm_eps": 1e-05,
    "tie_word_embeddings": False,
    "torch_dtype": "float16",
    "vocab_size": 32000,
}
# What a VCoder-DS checkpoint adds to it (the reference's
# initialize_seg_modules / initialize_depth_modules).
PUBLISHED_13B_DS = {**PUBLISHED_13B, "model_type": "vcoder_ds_llava",
                    "architectures": ["VCoderDSLlavaLlamaForCausalLM"],
                    "seg_mm_projector_type": "mlp2x_gelu", "seg_mm_hidden_size": 1024,
                    "depth_mm_projector_type": "mlp2x_gelu", "depth_mm_hidden_size": 1024}


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_standard_13b_config_equals_jax(model_type):
    j, t = JConfig.standard(model_type, "13b"), TConfig.standard(model_type, "13b")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.text.hidden_size, t.text.num_layers, t.text.num_heads, t.text.num_kv_heads,
            t.text.intermediate_size, t.text.head_dim) == (5120, 40, 40, 40, 13824, 128)
    assert t.to_hf_config() == j.to_hf_config()
    back = TConfig.from_hf_config(t.to_hf_config())
    assert dataclasses.asdict(back) == dataclasses.asdict(JConfig.from_hf_config(j.to_hf_config()))
    with pytest.raises(ValueError, match="Unknown size"):
        TConfig.standard(model_type, "70b")


@pytest.mark.parametrize("hf", [PUBLISHED_13B, PUBLISHED_13B_DS], ids=["llava", "vcoder_ds"])
def test_published_13b_fields_read_as_jax_reads_them(hf):
    t, j = TConfig.from_hf_config(dict(hf)), JConfig.from_hf_config(dict(hf))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.model_type == hf["model_type"]
    std = TConfig.standard(hf["model_type"], "13b")
    # Only the positions the checkpoint declares differ from the standard 13B.
    assert dataclasses.replace(t.text, max_position_embeddings=std.text.max_position_embeddings) \
        == std.text
    assert t.to_hf_config() == j.to_hf_config()


def test_13b_directory_name_routes_as_jax():
    for path in (f"/ckpts/{DIR_13B}", f"/ckpts/{DIR_13B}/", f"/o/{DIR_13B}/checkpoint-200",
                 "shi-labs/vcoder_ds_llava-v1.5-13b"):
        assert tname(path) == jname(path)
    assert tname(f"/x/{DIR_13B}") == DIR_13B


def _narrow(cfg_cls):
    """13B's head layout at a width the CPU runs in milliseconds."""
    base = cfg_cls.tiny("vcoder_ds_llava")
    return dataclasses.replace(base, text=dataclasses.replace(
        base.text, hidden_size=320, intermediate_size=864, num_heads=40, num_kv_heads=40))


IDS = [1, 10, 11, IMAGE_TOKEN_INDEX, DEPTH_TOKEN_INDEX, SEG_TOKEN_INDEX, 12, 16]


def _mm(i, tail=()):
    return ([1, 10 + i, 11, DEPTH_TOKEN_INDEX, 12, SEG_TOKEN_INDEX, 13, IMAGE_TOKEN_INDEX, 14,
             15 + i] + list(tail))


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _narrow(JConfig), _narrow(TConfig)
    assert (tcfg.text.num_heads, tcfg.text.num_kv_heads, tcfg.text.head_dim) == (40, 40, 8)
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(13), jcfg)
    rng = np.random.RandomState(13)
    jp = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32)), jp)
    out = dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
               tp=from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    for bits in (4, 8):
        jqp = jquant.quantize_params(jp, bits=bits, destroy=False)
        out[f"jq{bits}"] = jqp
        out[f"tq{bits}"] = from_jax_params(jax.tree.map(np.asarray, jqp), tcfg, device="cpu")
    hw = jcfg.vision.image_size
    out["px"] = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, hw, hw, 3)))
    out["pics"] = [[rng.randn(1, hw, hw, 3).astype(np.float32) for _ in range(3)]
                   for _ in range(3)]
    return out


@pytest.fixture
def w8a8_at_16(monkeypatch):
    """W8A8 from 16 tokens in both packages, so the narrow prompts engage it.
    JAX reads the threshold when it traces: its jit caches are cleared on
    both sides, so no trace made under one setting serves the other."""
    jax.clear_caches()
    monkeypatch.setattr(jq, "W8A8_MIN_TOKENS", 16)
    monkeypatch.setattr(tq, "W8A8_MIN_TOKENS", 16)
    yield
    jax.clear_caches()


def _tokens(res):
    return [int(t) for t in res.sequences[0][: int(res.num_generated[0])]]


def _jax_tokens(s, key, **kw):
    px = jnp.asarray(s["px"])
    return _tokens(jgen.generate(s[key], s["jcfg"], [IDS], px, px, px, max_new_tokens=MAX_NEW,
                                 temperature=0.0, attn_impl="xla", **kw))


@pytest.mark.parametrize("key", ["p", "q8", "q4"], ids=["f32", "int8", "int4"])
def test_greedy_generate_matches_jax(setup, key, w8a8_at_16):
    px = torch.from_numpy(np.array(setup["px"]))
    ref = _jax_tokens(setup, "j" + key)
    out = _tokens(tgen.generate(setup["t" + key], setup["tcfg"], [IDS], px, px, px,
                                max_new_tokens=MAX_NEW))
    assert out == ref and len(out) == MAX_NEW


# (weights, engine keywords): the paged engine over bf16-layout and int8
# pools, the int8-weight engine over int8 pools (engine E's configuration)
# and the int4-weight engine over both (engines D and D13).
ENGINES = [("p", {}), ("p", {"kv_quant": True}), ("q8", {"kv_quant": True}),
           ("q4", {}), ("q4", {"kv_quant": True})]


@pytest.mark.parametrize("key,kw", ENGINES,
                         ids=["bf16_pools", "int8_pools", "w8_int8_pools", "w4", "w4_int8_pools"])
def test_paged_engines_match_jax(setup, key, kw, w8a8_at_16):
    prompts = [_mm(0, [5, 9, 5, 9, 5]), _mm(1), _mm(2, [7, 8])]
    kw = {"max_batch": 2, "max_len": 256, "page_size": 8, "attn_impl": "xla", **kw}
    outs = []
    for eng in (jpe.PagedServingEngine(setup["jcfg"], setup["j" + key], **kw),
                tpe.PagedServingEngine(setup["tcfg"], setup["t" + key], device="cpu", **kw)):
        rids = [eng.add_request(p, images=im, segs=seg, depths=dep, max_new_tokens=8)
                for p, (im, seg, dep) in zip(prompts, setup["pics"])]
        res = eng.run()
        outs.append([res[r] for r in rids])
    assert outs[1] == outs[0]
    assert tuple(eng.k_pages.shape[-3:]) == (40, 8, 8)  # the port's pools: KH = 40, d 8


def test_loader_reads_once_and_stacks_on_the_target_device(setup, tmp_path):
    """A 13B file is 25 GiB: ``read_safetensors`` reads it into one buffer
    that every tensor views (not bytes and then a copy), and a load onto a
    device makes the stacked, transposed leaves there, equal to the host
    import's."""
    from vcoder_tpu_torch import checkpoint as ck

    path = str(tmp_path / DIR_13B)
    save_pretrained(path, setup["tp"], setup["tcfg"])
    file = os.path.join(path, "model.safetensors")
    state = ck.read_safetensors(file)
    with open(file, "rb") as f:
        header = json.loads(f.read(struct.unpack("<Q", f.read(8))[0]))
    # Each tensor lies in one buffer at its offset in the file's data.
    base = min(t.data_ptr() for t in state.values())
    assert len(state) > 50
    for name, t in state.items():
        assert t.data_ptr() - base == header[name]["data_offsets"][0], name
    host = ck.import_vcoder(state, setup["tcfg"])
    here = ck.import_vcoder(state, setup["tcfg"], device="cpu")
    meta = ck.import_vcoder(state, setup["tcfg"], device="meta")
    q = host["lm"]["layers"]["q_proj"]
    assert tuple(q.shape) == (2, 320, 320) and q.is_contiguous()
    assert meta["lm"]["layers"]["gate_proj"].device.type == "meta"
    assert tuple(meta["lm"]["layers"]["gate_proj"].shape) == (2, 320, 864)
    for name in ("q_proj", "gate_proj", "down_proj", "input_layernorm"):
        assert torch.equal(here["lm"]["layers"][name], host["lm"]["layers"][name])
        assert torch.equal(host["lm"]["layers"][name], setup["tp"]["lm"]["layers"][name])
    assert torch.equal(here["lm"]["lm_head"], setup["tp"]["lm"]["lm_head"])
    assert torch.equal(here["vision_tower"]["layers"]["fc1"],
                       setup["tp"]["vision_tower"]["layers"]["fc1"])
    _, loaded = ck.load_hf_checkpoint(path, dtype=torch.float32, device="cpu")
    assert torch.equal(loaded["lm"]["layers"]["o_proj"], setup["tp"]["lm"]["layers"]["o_proj"])


def test_13b_named_checkpoint_loads_4bit_as_jax(setup, tmp_path, w8a8_at_16):
    path = str(tmp_path / DIR_13B)
    save_pretrained(path, setup["tp"], setup["tcfg"])
    SimpleTokenizer({"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}).save_pretrained(path)
    jout = jbuilder.load_pretrained_model(path, load_4bit=True, dtype=jnp.float32)
    tout = tbuilder.load_pretrained_model(path, load_4bit=True, device="cpu",
                                          dtype=torch.float32)
    jm, tm = jout[1], tout[1]
    assert tm.config.model_type == jm.config.model_type == "vcoder_ds_llava"
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    # The name routes the seg and depth processors in both packages.
    assert [x is None for x in tout[2:5]] == [x is None for x in jout[2:5]] == [False] * 3
    assert tout[5] == jout[5]
    n = 0
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj"):
        jl, tl = jm.params["lm"]["layers"][name], tm.params["lm"]["layers"][name]
        assert isinstance(tl, QuantizedTensor) and tl.bits == 4
        np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
        np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
        n += 1
    np.testing.assert_array_equal(tm.params["lm"]["lm_head"].q.numpy(),
                                  np.asarray(jm.params["lm"]["lm_head"].q))
    assert n == 7
    px = setup["px"]
    ref = _tokens(jm.generate([IDS], jnp.asarray(px), jnp.asarray(px), jnp.asarray(px),
                              max_new_tokens=MAX_NEW, attn_impl="xla"))
    tpx = torch.from_numpy(np.array(px))
    assert _tokens(tm.generate([IDS], tpx, tpx, tpx, max_new_tokens=MAX_NEW)) == ref
