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
