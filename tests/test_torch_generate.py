"""Greedy generation and checkpoints: the port against the JAX package.

Greedy ``generate`` must give the same tokens as JAX, through the fused loop
and through the windowed stop-keyword path, and so must beam search and
prompt-lookup decoding through ``VCoderForCausalLM.generate``; a tiny checkpoint written by JAX
``save_pretrained`` must load through the port's ``load_pretrained_model``
(with the port's own safetensors reader) and give the same tokens; and the
port's ``save_pretrained`` output must load in JAX ``load_hf_checkpoint``
with equal arrays. Tiny DS config on the CPU, f32 unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu import checkpoint as jckpt
from vcoder_tpu import generation as jgen
from vcoder_tpu import mm_tokens as jtok
from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.simple_tokenizer import SimpleTokenizer as JTokenizer
from vcoder_tpu_torch import generation as tgen
from vcoder_tpu_torch import mm_tokens as ttok
from vcoder_tpu_torch.builder import VCoderForCausalLM, load_pretrained_model
from vcoder_tpu_torch.checkpoint import from_jax_params, save_pretrained
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer as TTokenizer

torch.set_num_threads(1)

PROMPTS = [
    "w10 w11 w12 <depth>\n<seg>\n<image>\nw20 w21 w22 w23 w24",
    "w30 <depth>\n<seg>\n<image>\nw40 w41",
]
MAX_NEW = 12


def _vocab(n):
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    vocab.update({f"w{i}": i for i in range(4, n)})
    return vocab


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.RandomState(0)
    jp = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32)), jp
    )
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    vocab = _vocab(jcfg.text.vocab_size)
    jt, tt = JTokenizer(vocab), TTokenizer(vocab)
    ids = [jtok.tokenizer_depth_seg_token(p, jt) for p in PROMPTS]
    assert ids == [ttok.tokenizer_depth_seg_token(p, tt) for p in PROMPTS]
    hw = jcfg.vision.image_size
    px = [rng.randn(2, hw, hw, 3).astype(np.float32) for _ in range(3)]
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jt=jt, tt=tt, ids=ids, px=px)


def _jax_generate(s, params=None, **kw):
    return jgen.generate(
        s["jp"] if params is None else params, s["jcfg"], s["ids"],
        *(jnp.asarray(p) for p in s["px"]), max_new_tokens=MAX_NEW, attn_impl="xla", **kw,
    )


def _torch_generate(s, params=None, **kw):
    return tgen.generate(
        s["tp"] if params is None else params, s["tcfg"], s["ids"],
        *(torch.from_numpy(p) for p in s["px"]), max_new_tokens=MAX_NEW, **kw,
    )


def test_greedy_generate_matches_jax(setup):
    ref = _jax_generate(setup, tokenizer=setup["jt"])
    out = _torch_generate(setup, tokenizer=setup["tt"])
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)
    assert out.texts == ref.texts


def test_greedy_generate_with_stop_keywords_matches_jax(setup):
    """The windowed path: a keyword taken from the unstopped output stops
    both packages at the same token."""
    plain = np.asarray(_jax_generate(setup).sequences)
    keyword = setup["jt"].decode([int(plain[0, 4])])
    jcrit = jtok.KeywordsStoppingCriteria([keyword], setup["jt"], len(setup["ids"][0]))
    tcrit = ttok.KeywordsStoppingCriteria([keyword], setup["tt"], len(setup["ids"][0]))
    ref = _jax_generate(setup, tokenizer=setup["jt"], stopping_criteria=jcrit)
    out = _torch_generate(setup, tokenizer=setup["tt"], stopping_criteria=tcrit)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)
    assert out.texts == ref.texts
    assert (out.sequences[0, 5:] == setup["jcfg"].text.eos_token_id).all()


@pytest.mark.parametrize("kw", [dict(num_beams=4), dict(num_beams=4, length_penalty=0.7),
                                dict(lookahead=8)], ids=["beams", "beams_length_penalty", "lookahead"])
def test_generate_beams_and_lookahead_match_jax(setup, kw):
    """Beam search and prompt-lookup decoding through
    ``VCoderForCausalLM.generate`` give JAX's ``VCoderForCausalLM.generate``
    tokens."""
    from vcoder_tpu.builder import VCoderForCausalLM as JModel

    ref = JModel(setup["jcfg"], setup["jp"]).generate(
        setup["ids"], *(jnp.asarray(p) for p in setup["px"]), max_new_tokens=MAX_NEW,
        tokenizer=setup["jt"], attn_impl="xla", **kw)
    model = VCoderForCausalLM(setup["tcfg"], setup["tp"])
    out = model.generate(setup["ids"], *(torch.from_numpy(p) for p in setup["px"]),
                         max_new_tokens=MAX_NEW, tokenizer=setup["tt"], **kw)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)
    assert out.texts == ref.texts


def test_generate_with_those_modes_off_matches_jax_greedy(setup):
    ref = _jax_generate(setup)
    model = VCoderForCausalLM(setup["tcfg"], setup["tp"])
    out = model.generate(setup["ids"], *(torch.from_numpy(p) for p in setup["px"]),
                         max_new_tokens=MAX_NEW, num_beams=1, length_penalty=1.0, lookahead=0)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)


def test_jax_checkpoint_loads_in_port(setup, tmp_path):
    path = str(tmp_path / "vcoder_ds_llava-tiny")
    jckpt.save_pretrained(path, setup["jp"], setup["jcfg"])
    setup["jt"].save_pretrained(path)
    tok, model, proc, seg_proc, depth_proc, ctx = load_pretrained_model(
        path, device="cpu", dtype=torch.float32
    )
    assert seg_proc is proc and depth_proc is proc
    assert ctx == setup["jcfg"].model_max_length
    assert model.config == setup["tcfg"]
    ref = _jax_generate(setup)
    out = model.generate(setup["ids"], *(torch.from_numpy(p) for p in setup["px"]),
                         max_new_tokens=MAX_NEW, tokenizer=tok)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_loads_in_jax(setup, tmp_path, dtype):
    jp = jax.tree.map(lambda a: a.astype(dtype), setup["jp"])
    tp = from_jax_params(jax.tree.map(np.asarray, jp), setup["tcfg"], device="cpu")
    path = str(tmp_path / "ckpt")
    save_pretrained(path, tp, setup["tcfg"])
    cfg, loaded = jckpt.load_hf_checkpoint(path, dtype=None)
    assert cfg == setup["jcfg"]
    ref_leaves, ref_def = jax.tree.flatten(jp)
    got_leaves, got_def = jax.tree.flatten(loaded)
    assert ref_def == got_def
    for a, b in zip(ref_leaves, got_leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("top_p", [0.0, 0.3, 0.9, 1.0])
def test_nucleus_filter_matches_jax(top_p):
    logits = np.random.RandomState(7).randn(3, 50).astype(np.float32) * 3.0
    ref = np.asarray(jgen.nucleus_filter(jnp.asarray(logits), top_p))
    out = tgen.nucleus_filter(torch.from_numpy(logits), top_p).numpy()
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_array_equal(out[~np.isinf(out)], ref[~np.isinf(ref)])


def test_sampling_stays_in_nucleus_and_follows_probabilities():
    """Sampled bits differ from JAX (torch.Generator), so check the
    distribution: draws stay inside the top-p nucleus, are reproducible for
    a seed, and their frequencies follow the renormalized probabilities."""
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0, -3.0]]).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    draws = tgen.sample_token(logits, gen, temperature=0.7, top_p=0.9)
    again = tgen.sample_token(logits, torch.Generator().manual_seed(0), temperature=0.7, top_p=0.9)
    assert torch.equal(draws, again)
    kept = ~torch.isinf(tgen.nucleus_filter(logits[:1] / 0.7, 0.9))[0]
    assert kept[draws].all()
    probs = torch.softmax(torch.where(kept, logits[0] / 0.7, torch.tensor(float("-inf"))), -1)
    freq = torch.bincount(draws, minlength=5).float() / len(draws)
    # 4000 draws: the binomial standard error is below 0.008 for every token.
    assert (freq - probs).abs().max() < 0.04
    assert torch.equal(tgen.sample_token(logits[:2], None, temperature=0.0, top_p=0.5),
                       torch.zeros(2, dtype=torch.int64))
