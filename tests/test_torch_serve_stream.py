"""Streaming generation: the port's ``generate_stream`` against the JAX
package's (tiny DS config, f32).

* The chunk sequence equals JAX's at lookahead 0 (one token per step) and 8
  (speculative, from a worker thread), and the last chunk is ``generate``'s
  text.
* A stop string that lands mid-chunk is cut, at both lookaheads, as in JAX.
* A failure injected into the speculative worker thread reaches the
  consumer (JAX ends that stream as if it were complete), and ``Chat``'s
  gate turns it into an ``error_code`` 1 chunk.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu import generation as jgen
from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.simple_tokenizer import SimpleTokenizer as JTokenizer
from vcoder_tpu_torch import generation as tgen
from vcoder_tpu_torch import speculative as tspec
from vcoder_tpu_torch.checkpoint import from_jax_params
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.constants import DEPTH_TOKEN_INDEX, IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX
from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer as TTokenizer

torch.set_num_threads(1)

IDS = [1, 7, 8, 9, DEPTH_TOKEN_INDEX, SEG_TOKEN_INDEX, IMAGE_TOKEN_INDEX, 7, 8, 9, 7, 8]
MAX_NEW = 16


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(1), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    vocab.update({f"w{i}": i for i in range(4, jcfg.text.vocab_size)})
    hw = jcfg.vision.image_size
    px = [np.random.RandomState(4).randn(1, hw, hw, 3).astype(np.float32) for _ in range(3)]
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, jt=JTokenizer(vocab), tt=TTokenizer(vocab),
                px=px)


def _streams(s, **kw):
    ref = list(jgen.generate_stream(s["jp"], s["jcfg"], [IDS], *(jnp.asarray(p) for p in s["px"]),
                                    tokenizer=s["jt"], max_new_tokens=MAX_NEW, temperature=0.0,
                                    attn_impl="xla", **kw))
    got = list(tgen.generate_stream(s["tp"], s["tcfg"], [IDS],
                                    *(torch.from_numpy(p) for p in s["px"]), tokenizer=s["tt"],
                                    max_new_tokens=MAX_NEW, temperature=0.0, **kw))
    return ref, got


@pytest.mark.parametrize("lookahead", [0, 8])
def test_stream_chunks_match_jax(setup, lookahead):
    ref, got = _streams(setup, lookahead=lookahead)
    assert got == ref
    assert len(got) == MAX_NEW
    full = tgen.generate(setup["tp"], setup["tcfg"], [IDS],
                         *(torch.from_numpy(p) for p in setup["px"]), max_new_tokens=MAX_NEW,
                         tokenizer=setup["tt"])
    assert got[-1] == full.texts[0]
    assert all(b.startswith(a) for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("lookahead", [0, 8])
def test_stop_string_mid_chunk_is_cut(setup, lookahead):
    """A stop string made of the 4th token's word and the 5th's first
    letters ends inside a token: the text stops just before it, as JAX's."""
    _, plain = _streams(setup, lookahead=0)
    words = plain[-1].split()
    stop = f"{words[3]} {words[4][:2]}"
    ref, got = _streams(setup, lookahead=lookahead, stop_str=stop)
    assert got == ref
    assert all(stop not in c for c in got)
    assert got[-1] == " ".join(words[:3]) + " "


def test_worker_thread_failure_reaches_consumer(setup, monkeypatch):
    calls = []
    step = tspec._spec_step

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected failure in the verify step")
        return step(*args, **kw)

    monkeypatch.setattr(tspec, "_spec_step", failing)
    got = []
    with pytest.raises(RuntimeError, match="injected failure"):
        for text in tgen.generate_stream(setup["tp"], setup["tcfg"], [IDS],
                                         *(torch.from_numpy(p) for p in setup["px"]),
                                         tokenizer=setup["tt"], max_new_tokens=MAX_NEW,
                                         temperature=0.0, lookahead=4):
            got.append(text)
    # The tokens accepted before the failure were delivered first.
    assert 1 <= len(got) < MAX_NEW


def test_chat_gate_reports_worker_thread_failure(tmp_path, monkeypatch):
    """Through ``Chat``: the failure becomes an error chunk, not a short
    stream that passes for a complete one."""
    import json

    from tests.test_torch_chat_server import f32_loads, make_tiny_checkpoint, request
    from vcoder_tpu_torch.serve.chat import Chat

    path, _, _ = make_tiny_checkpoint(tmp_path / "vcoder_ds_llava-tiny")
    with f32_loads():
        chat = Chat(path, device="cpu")

    def broken(*args, **kw):
        raise RuntimeError("injected failure in the verify step")

    monkeypatch.setattr(tspec, "_spec_step", broken)
    chunks = [json.loads(c[:-1]) for c in chat.generate_stream_gate(request(lookahead=8))]
    assert chunks[-1]["error_code"] == 1
    assert all(c["error_code"] == 0 for c in chunks[:-1])
