"""Beam search: the port's ``generate(num_beams=W)`` against the JAX package
and against the recorded transformers vectors.

Deterministic beams must give JAX's tokens exactly (tiny DS config, f32,
ragged multimodal rows; widths 2 and 4; length penalties 0.5, 1 and 2; an
EOS that retires hypotheses). Beam-sample mode (temperature > 0) draws other
bits than JAX, so it is held in distribution only: reproducible for one
generator seed, every live candidate inside its beam's nucleus, and the
deterministic search as the temperature goes to 0.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu import generation as jgen
from vcoder_tpu import mm_tokens as jtok
from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.simple_tokenizer import SimpleTokenizer as JTokenizer
from vcoder_tpu_torch import generation as tgen
from vcoder_tpu_torch.builder import VCoderForCausalLM
from vcoder_tpu_torch.checkpoint import from_jax_params, import_llama
from vcoder_tpu_torch.config import TextConfig as TText
from vcoder_tpu_torch.config import VCoderConfig as TConfig

torch.set_num_threads(1)

PROMPTS = [
    "w10 w11 w12 <depth>\n<seg>\n<image>\nw20 w21 w22 w23 w24",
    "w30 <depth>\n<seg>\n<image>\nw40 w41",
]
MAX_NEW = 10


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(5), jcfg)
    rng = np.random.RandomState(2)
    jp = jax.tree.map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32)), jp
    )
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    vocab.update({f"w{i}": i for i in range(4, jcfg.text.vocab_size)})
    ids = [jtok.tokenizer_depth_seg_token(p, JTokenizer(vocab)) for p in PROMPTS]
    assert len(ids[0]) != len(ids[1])  # ragged rows
    hw = jcfg.vision.image_size
    px = [rng.randn(2, hw, hw, 3).astype(np.float32) for _ in range(3)]
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, ids=ids, px=px)


def _with_eos(s, eos):
    return (dataclasses.replace(s["jcfg"], text=dataclasses.replace(s["jcfg"].text, eos_token_id=eos)),
            dataclasses.replace(s["tcfg"], text=dataclasses.replace(s["tcfg"].text, eos_token_id=eos)))


def _pair(s, jcfg=None, tcfg=None, **kw):
    ref = jgen.generate(s["jp"], jcfg or s["jcfg"], s["ids"], *(jnp.asarray(p) for p in s["px"]),
                        max_new_tokens=MAX_NEW, attn_impl="xla", **kw)
    out = tgen.generate(s["tp"], tcfg or s["tcfg"], s["ids"],
                        *(torch.from_numpy(p) for p in s["px"]), max_new_tokens=MAX_NEW, **kw)
    return ref, out


@pytest.mark.parametrize("beams,penalty", [(2, 1.0), (4, 1.0), (2, 0.5), (4, 2.0)])
def test_beams_match_jax(setup, beams, penalty):
    ref, out = _pair(setup, num_beams=beams, length_penalty=penalty)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)


def test_beams_differ_from_greedy(setup):
    """The search must be a search: at W=4 some row leaves greedy's path."""
    _, beams = _pair(setup, num_beams=4)
    greedy = tgen.generate(setup["tp"], setup["tcfg"], setup["ids"],
                           *(torch.from_numpy(p) for p in setup["px"]), max_new_tokens=MAX_NEW)
    assert not np.array_equal(beams.sequences, greedy.sequences)


@pytest.mark.parametrize("penalty", [0.0, 1.0, 2.0])
def test_beams_with_eos_retirement_match_jax(setup, penalty):
    """A token the search emits is declared EOS, so hypotheses retire into
    the finished set mid-search; with penalty 0 a retired (shorter)
    hypothesis must win."""
    _, probe = _pair(setup, num_beams=3)
    eos = int(probe.sequences[0, 3])
    jcfg, tcfg = _with_eos(setup, eos)
    ref, out = _pair(setup, jcfg, tcfg, num_beams=3, length_penalty=penalty)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)
    if penalty == 0.0:
        assert (out.sequences == eos).any()


def test_beam_width_one_is_greedy(setup):
    plan = tgen._prepare_inputs(setup["tp"], setup["tcfg"], setup["ids"],
                                *(torch.from_numpy(p) for p in setup["px"]))
    _, plan_np, arrays, im, sg, dp = plan
    got = tgen._beam_generate(
        setup["tp"], setup["tcfg"], arrays, im, sg, dp, None, max_new_tokens=MAX_NEW,
        num_beams=1, length_penalty=1.0, eos_id=setup["tcfg"].text.eos_token_id,
        use_vcoder_emb=plan_np.use_vcoder_emb, attn_impl="auto")
    greedy = tgen.generate(setup["tp"], setup["tcfg"], setup["ids"],
                           *(torch.from_numpy(p) for p in setup["px"]), max_new_tokens=MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), greedy.sequences)


def _golden():
    import os

    return np.load(os.path.join(os.path.dirname(__file__), "golden", "hf_golden.npz"),
                   allow_pickle=False)


def test_golden_vectors_anchor_beams():
    """The committed transformers beam outputs (the vectors
    ``tests/test_beam_search.py::test_golden_vectors_anchor_beams`` reads)."""
    g = _golden()
    txt = TText(vocab_size=128, hidden_size=32, intermediate_size=64, num_layers=2,
                num_heads=4, num_kv_heads=2, max_position_embeddings=128)
    state = {k[len("beam.state."):]: torch.from_numpy(g[k]) for k in g.files
             if k.startswith("beam.state.")}
    params = {"lm": import_llama(state, txt)}
    for name in ("plain", "eos", "eos_lp0", "lp05", "lp2"):
        max_new, beams, eos = (int(x) for x in g[f"beam.{name}.args"])
        cfg = TConfig(model_type="llava", text=dataclasses.replace(txt, eos_token_id=eos))
        got = tgen.generate(params, cfg, [list(r) for r in g[f"beam.{name}.ids"]],
                            max_new_tokens=max_new, num_beams=beams,
                            length_penalty=float(g[f"beam.{name}.lp"]))
        np.testing.assert_array_equal(got.sequences, g[f"beam.{name}.gen"], err_msg=name)


def test_beam_sample_in_distribution(setup, monkeypatch):
    """Beam-sample mode: one seed gives one result, another seed another;
    every live candidate has a finite warped score, i.e. its token lies in
    its beam's top-p nucleus; and a cold temperature is the deterministic
    search."""
    model = VCoderForCausalLM(setup["tcfg"], setup["tp"])
    px = [torch.from_numpy(p) for p in setup["px"]]
    live_scores = []
    select = tgen._beam_select

    def spy(s, logprobs, scores, *args, **kw):
        out = select(s, logprobs, scores, *args, **kw)
        live_scores.append(out[0][~out[6]])
        return out

    monkeypatch.setattr(tgen, "_beam_select", spy)
    kw = dict(max_new_tokens=MAX_NEW, num_beams=3, temperature=0.9, top_p=0.6)
    a = model.generate(setup["ids"], *px, seed=0, **kw).sequences
    assert live_scores and all(torch.isfinite(x).all() for x in live_scores)
    b = model.generate(setup["ids"], *px, seed=0, **kw).sequences
    c = model.generate(setup["ids"], *px, seed=1, **kw).sequences
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    det = model.generate(setup["ids"], *px, max_new_tokens=MAX_NEW, num_beams=3).sequences
    cold = model.generate(setup["ids"], *px, max_new_tokens=MAX_NEW, num_beams=3,
                          temperature=0.01, seed=0).sequences
    np.testing.assert_array_equal(cold, det)
