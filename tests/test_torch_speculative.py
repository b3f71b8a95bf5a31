"""Prompt-lookup drafting, the window acceptance rule and per-row sampling:
the port against the JAX package on random windows (exact: integer logic,
and greedy argmax of identical f32 logits)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu import generation as jgen
from vcoder_tpu import speculative as jspec
from vcoder_tpu_torch import generation as tgen
from vcoder_tpu_torch import speculative as tspec

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", range(4))
def test_accept_window_matches_jax(seed):
    """Random windows with planted draft matches, EOS inside and outside the
    accepted prefix, budget caps, sampling and inactive rows."""
    rng = np.random.default_rng(seed)
    B, k, eos = 16, 5, 2
    outs = rng.integers(0, 6, (B, k)).astype(np.int32)
    draft = outs[:, :-1].copy()
    cut = rng.integers(0, k, B)
    for b in range(B):
        draft[b, cut[b]:] = rng.integers(0, 6, k - 1 - cut[b])
    no_accept = rng.random(B) < 0.2
    inactive = rng.random(B) < 0.2
    budget = rng.integers(1, k + 2, B).astype(np.int32)
    emit_j, nxt_j = jspec.accept_window(jnp.asarray(outs), jnp.asarray(draft),
                                        jnp.asarray(no_accept), jnp.asarray(inactive),
                                        jnp.asarray(budget), eos)
    emit_t, nxt_t = tspec.accept_window(torch.from_numpy(outs), torch.from_numpy(draft),
                                        torch.from_numpy(no_accept), torch.from_numpy(inactive),
                                        torch.from_numpy(budget), eos)
    np.testing.assert_array_equal(emit_t.numpy(), np.asarray(emit_j))
    np.testing.assert_array_equal(nxt_t.numpy(), np.asarray(nxt_j))
    assert (emit_t.numpy()[inactive] == 0).all()
    assert (emit_t.numpy() <= budget).all()


@pytest.mark.parametrize("seed", range(3))
def test_ngram_draft_matches_jax(seed):
    """Host drafting (3-gram, else 2-gram, else zeros) against JAX's numpy
    twin and its on-device drafter, including full and short histories."""
    rng = np.random.default_rng(seed)
    B, H, nd = 6, 40, 3
    hist = rng.integers(0, 5, (B, H)).astype(np.int32)
    hist_len = np.asarray([0, 2, 3, 17, 39, 40], np.int32)
    ref = jspec.ngram_draft_np(hist, hist_len, nd)
    np.testing.assert_array_equal(tspec.ngram_draft_np(hist, hist_len, nd), ref)
    np.testing.assert_array_equal(
        np.asarray(jspec.ngram_draft(jnp.asarray(hist), jnp.asarray(hist_len), nd)), ref)
    rows = [list(hist[b, : hist_len[b]]) for b in range(B)] + [None]
    np.testing.assert_array_equal(tspec.draft_from_ids(rows, nd), jspec.draft_from_ids(rows, nd))


def test_sample_token_batch_greedy_and_tiny_top_p_match_jax():
    """Greedy rows, and sampling rows whose top_p -> 0 nucleus keeps only the
    argmax, give JAX's tokens whatever the random bits."""
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 50)).astype(np.float32) * 3
    temp = np.asarray([0, 0.7, 1.3, 0, 2.0, 0.5], np.float32)
    top_p = np.asarray([1, 1e-9, 1e-9, 0.5, 1e-9, 1e-9], np.float32)
    ref = jgen.sample_token_batch(jnp.asarray(logits), jax.random.PRNGKey(0),
                                  jnp.asarray(temp), jnp.asarray(top_p))
    out = tgen.sample_token_batch(torch.from_numpy(logits), torch.Generator().manual_seed(0),
                                  torch.from_numpy(temp), torch.from_numpy(top_p))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    greedy = tgen.sample_token_batch(torch.from_numpy(logits), None, torch.from_numpy(temp),
                                     torch.from_numpy(top_p), sampling=False)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1))


@pytest.mark.parametrize("seed", range(3))
def test_device_ngram_draft_matches_jax(seed):
    """The port's on-device drafter against JAX's, on the cases of the host
    test (short, full and empty histories) plus sentinel barriers."""
    rng = np.random.default_rng(seed)
    B, H, nd = 6, 40, 3
    hist = rng.integers(0, 5, (B, H)).astype(np.int32)
    hist[1, 5] = -200  # a sentinel never matches
    hist_len = np.asarray([0, 2, 3, 17, 39, 40], np.int32)
    ref = np.asarray(jspec.ngram_draft(jnp.asarray(hist), jnp.asarray(hist_len), nd))
    got = tspec.ngram_draft(torch.from_numpy(hist).long(), torch.from_numpy(hist_len).long(), nd)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_build_history_matches_jax():
    rows = [[1, 5, -200, 7, 8], [1, 9], [3, 3, 3, 3, 3, 3, 3]]
    for a, b in zip(tspec.build_history(rows, 6, 4), jspec.build_history(rows, 6, 4)):
        np.testing.assert_array_equal(a, b)


def test_trim_cache_matches_jax():
    from vcoder_tpu.models.llama import KVCache as JCache
    from vcoder_tpu_torch.models.llama import KVCache as TCache

    k = np.random.RandomState(0).randn(2, 3, 9, 1, 4).astype(np.float32)
    new_len = np.asarray([0, 5, 9], np.int32)
    ref = jspec.trim_cache(JCache(k=jnp.asarray(k), v=jnp.asarray(k),
                                  kv_mask=jnp.ones((3, 9), bool),
                                  length=jnp.full((3,), 9, jnp.int32)), jnp.asarray(new_len))
    got = tspec.trim_cache(TCache(k=torch.from_numpy(k), v=torch.from_numpy(k),
                                  kv_mask=torch.ones((3, 9), dtype=torch.bool),
                                  length=torch.full((3,), 9)), torch.from_numpy(new_len).long())
    np.testing.assert_array_equal(got.kv_mask.numpy(), np.asarray(ref.kv_mask))
    np.testing.assert_array_equal(got.length.numpy(), np.asarray(ref.length))
    assert got.k is not None and torch.equal(got.k, torch.from_numpy(k))


@pytest.fixture(scope="module")
def model_setup():
    from vcoder_tpu.config import VCoderConfig as JConfig
    from vcoder_tpu.models import vcoder as jvcoder
    from vcoder_tpu_torch.checkpoint import from_jax_params
    from vcoder_tpu_torch.config import VCoderConfig as TConfig
    from vcoder_tpu_torch.constants import DEPTH_TOKEN_INDEX, IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX

    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(1), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    # Repetitive prompts, so the drafter finds matches and windows accept.
    ids = [[1, 7, 8, 9, DEPTH_TOKEN_INDEX, SEG_TOKEN_INDEX, IMAGE_TOKEN_INDEX, 7, 8, 9, 7, 8],
           [1, 5, DEPTH_TOKEN_INDEX, SEG_TOKEN_INDEX, IMAGE_TOKEN_INDEX, 5, 6]]
    hw = jcfg.vision.image_size
    rng = np.random.RandomState(4)
    px = [rng.randn(2, hw, hw, 3).astype(np.float32) for _ in range(3)]
    return jcfg, tcfg, jp, tp, ids, px


def _gen_pair(s, max_new, eos=None, **kw):
    import dataclasses

    jcfg, tcfg, jp, tp, ids, px = s
    if eos is not None:
        jcfg = dataclasses.replace(jcfg, text=dataclasses.replace(jcfg.text, eos_token_id=eos))
        tcfg = dataclasses.replace(tcfg, text=dataclasses.replace(tcfg.text, eos_token_id=eos))
    ref = jgen.generate(jp, jcfg, ids, *(jnp.asarray(p) for p in px), max_new_tokens=max_new,
                        attn_impl="xla", **kw)
    out = tgen.generate(tp, tcfg, ids, *(torch.from_numpy(p) for p in px),
                        max_new_tokens=max_new, **kw)
    return ref, out


@pytest.mark.parametrize("k", [2, 4, 8])
@pytest.mark.parametrize("eos", [None, "emitted"])
def test_generate_lookahead_matches_greedy_and_jax(model_setup, k, eos):
    """``generate(lookahead=k)``: the port's greedy tokens and
    ``num_generated``, and JAX's speculative ones; with an EOS the search
    emits, rows stop at it (the trailing-EOS count rule)."""
    if eos == "emitted":
        _, probe = _gen_pair(model_setup, 16)
        eos = int(probe.sequences[0, 5])
    ref, out = _gen_pair(model_setup, 16, eos=eos, lookahead=k)
    _, greedy = _gen_pair(model_setup, 16, eos=eos)
    np.testing.assert_array_equal(out.sequences, greedy.sequences)
    np.testing.assert_array_equal(out.num_generated, greedy.num_generated)
    np.testing.assert_array_equal(out.sequences, np.asarray(ref.sequences))
    np.testing.assert_array_equal(out.num_generated, ref.num_generated)


def test_speculative_saves_dispatches(model_setup):
    """Some windows accept drafts: fewer verify dispatches than tokens."""
    jcfg, tcfg, jp, tp, ids, px = model_setup
    seqs, num_gen, iters = tspec.generate_speculative(
        tp, tcfg, ids[:1], *(torch.from_numpy(p[:1]) for p in px), max_new_tokens=24,
        lookahead=4, poll_every=1)
    assert int(num_gen[0]) == 24 and iters < 23


def test_on_tokens_streams_every_token_and_abort_stops_callbacks(model_setup):
    jcfg, tcfg, jp, tp, ids, px = model_setup
    args = (tp, tcfg, ids, *(torch.from_numpy(p) for p in px))
    seqs, num_gen, _ = tspec.generate_speculative(*args, max_new_tokens=12, lookahead=4)
    calls = []
    tspec.generate_speculative(*args, max_new_tokens=12, lookahead=4,
                               on_tokens=lambda b, t: calls.append((b, list(t))))
    for b in range(2):
        got = [t for r, ts in calls if r == b for t in ts]
        assert got == seqs[b, : num_gen[b]].tolist()
    # Abort on the third callback: no callback after the False, to any row.
    calls.clear()

    def stop_at_three(b, toks):
        calls.append((b, list(toks)))
        return len(calls) < 3

    tspec.generate_speculative(*args, max_new_tokens=12, lookahead=4, on_tokens=stop_at_three)
    assert len(calls) == 3
    # Abort on the very first (row 0's first token): row 1 is never called.
    calls.clear()

    def stop_at_once(b, toks):
        calls.append(b)
        return False

    tspec.generate_speculative(*args, max_new_tokens=12, lookahead=4, on_tokens=stop_at_once)
    assert calls == [0]
