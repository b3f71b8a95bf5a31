"""The port's ``PagedServingEngine`` against the JAX one (CPU, tiny DS config
with GQA: 4 query heads over 2 KV heads, f32).

The same requests -- most with RGB + seg + depth pixels -- must give
identical greedy tokens with bf16-layout pools (held in f32), int8 pools,
speculative verify, ``sync_every`` windows, chunked prefill with the prefix cache over a two-turn
conversation (equal prefix-hit counters), a pool tight enough to preempt
(equal preemption counts), a pool too small for one request (only that one
fails, with the same error), deferral, and a cancel in the middle of a
lockstep group. Mirrors tests/test_paged_engine.py, test_chunked_prefill.py,
test_prefix_cache.py and test_preemption.py. Exact equality: greedy tokens
of two f32 implementations agree unless two logits tie to ~1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.constants import DEPTH_TOKEN_INDEX, IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.multimodal import build_splice_plan as jplan
from vcoder_tpu.serve import paged_engine as jpe
from vcoder_tpu_torch.checkpoint import from_jax_params
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.models import vcoder as tvcoder
from vcoder_tpu_torch.multimodal import build_splice_plan as tplan
from vcoder_tpu_torch.serve import paged_engine as tpe

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    assert jcfg.text.num_kv_heads < jcfg.text.num_heads
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    hw = jcfg.vision.image_size
    rng = np.random.RandomState(0)
    pics = [[rng.randn(1, hw, hw, 3).astype(np.float32) for _ in range(3)] for _ in range(3)]
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, pics=pics)


def _mm(i, tail=()):
    return ([1, 10 + i, 11, DEPTH_TOKEN_INDEX, 12, SEG_TOKEN_INDEX, 13, IMAGE_TOKEN_INDEX, 14, 15 + i]
            + list(tail))


def _text(i, n=34):
    return [1 + i] + [20 + ((i * 7 + j) % 50) for j in range(n - 1)]


def _engines(s, **kw):
    kw = {"max_batch": 2, "max_len": 256, "page_size": 8, "attn_impl": "xla", **kw}
    return (jpe.PagedServingEngine(s["jcfg"], s["jp"], **kw),
            tpe.PagedServingEngine(s["tcfg"], s["tp"], device="cpu", **kw))


def _add(eng, prompts, pics, max_new):
    rids = []
    for p, px in zip(prompts, pics):
        im, seg, dep = px if px is not None else (None, None, None)
        rids.append(eng.add_request(p, images=im, segs=seg, depths=dep, max_new_tokens=max_new))
    return rids


def _free(eng):
    """Free pages of a single-device engine (JAX keeps one list per shard)."""
    return len(eng.free_pages[0] if isinstance(eng.free_pages[0], list) else eng.free_pages)


def _serve_both(s, prompts, pics, max_new=6, **kw):
    outs, engs = [], _engines(s, **kw)
    for eng in engs:
        rids = _add(eng, prompts, pics, max_new)
        res = eng.run()
        outs.append([res[r] for r in rids])
    assert all(len(o) == max_new for o in outs[1]) or any(eng.failed for eng in engs)
    return outs, engs


@pytest.mark.parametrize("kw", [{}, {"kv_quant": True}, {"speculative": 4}, {"sync_every": 3}],
                         ids=["bf16_layout", "int8_pools", "speculative4", "sync_every3"])
def test_multimodal_requests_match_jax(setup, kw):
    prompts = [_mm(0, [5, 9, 5, 9, 5]), _mm(1), _mm(2, [7, 8])]
    (ref, out), (_, eng) = _serve_both(setup, prompts, setup["pics"], max_new=8, **kw)
    assert out == ref
    assert all(not p for p in eng.row_pages)  # pages recycled


def test_chunked_prefill_prefix_cache_two_turns_match_jax(setup):
    kw = dict(chunked_prefill=16, prefix_cache=True, prefix_chunk=16)
    engs = _engines(setup, **kw)
    turn1 = [_mm(0), _mm(1)]
    pics = setup["pics"][:2]
    outs = []
    for eng in engs:
        rids = _add(eng, turn1, pics, 6)
        res = eng.run()
        first = [res[r] for r in rids]
        turn2 = [p + o + [7, 8] for p, o in zip(turn1, first)]
        rids = _add(eng, turn2, pics, 6)
        res = eng.run()
        outs.append((first, [res[r] for r in rids], eng.prefix_stats(), eng.admit_group_sizes))
    assert outs[1][:2] == outs[0][:2]
    assert outs[1][2] == outs[0][2] and outs[1][2]["hits"] >= 2
    assert outs[1][3] == outs[0][3]


def test_preemption_matches_jax(setup):
    prompts = [_text(0), _text(1)]
    (ref, out), engs = _serve_both(setup, prompts, [None, None], max_new=24, total_pages=14)
    assert out == ref
    assert engs[1].preemptions == engs[0].preemptions >= 1
    assert _free(engs[1]) == engs[1].total_pages - 2
    assert not engs[1].has_work()


def test_pool_too_small_fails_only_that_request(setup):
    events = []
    for eng in _engines(setup, max_batch=1, total_pages=3):
        big, small = _add(eng, [list(range(2, 80)), [1, 5, 6, 7]], [None, None], 3)
        ev = []
        while eng.has_work():
            ev += eng.step()
        events.append((ev, eng.pop_error(big), eng.pop_error(small)))
    assert events[1][0] == events[0][0]
    ev, err, ok = events[1]
    assert ev[0] == (0, 2, True) and ok is None
    assert "page pool exhausted" in err and "page pool exhausted" in events[0][1]
    assert [t for r, t, _ in ev if r == 1] and all(r in (0, 1) for r, _, _ in ev)


def test_deferral_matches_jax(setup):
    """Two usable pages: the 2-page request waits until the first frees."""
    outs = []
    for eng in _engines(setup, max_len=256, page_size=64, total_pages=4):
        rids = _add(eng, [[1, 5, 6, 7], list(range(2, 70))], [None, None], 3)
        eng.step()
        assert [r.request_id for r in eng.queue] == [rids[1]]  # deferred
        res = eng.run()
        outs.append([res[r] for r in rids])
        assert all(not p for p in eng.row_pages)
    assert outs[1] == outs[0] and all(len(o) == 3 for o in outs[1])


def test_cancel_mid_group_matches_jax(setup):
    outs = []
    for eng in _engines(setup, max_batch=4, chunked_prefill=8, max_len=128):
        free0 = _free(eng)
        eng.add_request(_text(2, n=8), max_new_tokens=48)
        while not any(eng.active):
            eng.step()
        ra = eng.add_request(_text(3, n=70), max_new_tokens=4)
        rb = eng.add_request(_text(4, n=12), max_new_tokens=5)
        eng.step()  # stage both; at most one chunk ran
        assert eng._pending is not None and eng.cancel(ra)
        got = {}
        steps = 0
        while eng.has_work():
            for rid, tok, _ in eng.step():
                got.setdefault(rid, []).append(int(tok))
            steps += 1
            assert steps < 500
        assert ra not in got and len(got[rb]) == 5
        assert _free(eng) == free0
        outs.append(got)
    assert outs[1] == outs[0]


def test_warmup_close_and_vision_cache(setup):
    """warmup_chunks leaves every page but the scratch page bit-identical on a
    live engine; close() frees the pools, the table, the pending groups and
    the vision-table cache, and is idempotent; the params survive."""
    eng = tpe.PagedServingEngine(setup["tcfg"], setup["tp"], max_batch=2, max_len=256,
                                 page_size=8, attn_impl="xla", chunked_prefill=16, device="cpu")
    _add(eng, [_mm(0)], setup["pics"][:1], 3)
    eng.run()
    assert len(eng._vis_cache) == 1
    before = [t.clone() for t in (eng.k_pages, eng.v_pages)]
    eng.warmup_chunks()
    for b, t in zip(before, (eng.k_pages, eng.v_pages)):
        assert torch.equal(b[:, :-1], t[:, :-1])
    eng.close()
    assert eng.k_pages is None and eng.v_pages is None and eng.tokens is None
    assert not eng._vis_cache and eng._table_dev is None and not eng._pending_groups
    eng.close()
    assert setup["tp"]["lm"]["embed_tokens"].abs().sum() > 0


def test_plan_embeds_and_chunk_slice_match_jax(setup):
    s = setup
    prompt = _mm(0, [7, 8])
    kw = dict(num_patches=s["jcfg"].vision.num_patches, has_image=True, has_seg=True,
              has_depth=True, ds_mode=True, pad_to=32)
    jarr = jvcoder.plan_to_arrays(jplan([prompt], **kw))
    tarr = tvcoder.plan_to_arrays(tplan([prompt], **kw), "cpu")
    im, seg, dep = s["pics"][0]
    ref = jpe._plan_embeds(s["jp"], s["jcfg"], jarr, jnp.asarray(im), jnp.asarray(seg),
                           jnp.asarray(dep), use_vcoder_emb=True, has_images=True,
                           has_segs=True, has_depths=True, attn_impl="xla")
    out = tpe._plan_embeds(s["tp"], s["tcfg"], tarr, *(torch.from_numpy(x) for x in (im, seg, dep)),
                           use_vcoder_emb=True, attn_impl="xla")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    # The chunk slice clamps its start as dynamic_slice_in_dim does.
    src = np.arange(3 * 20).reshape(3, 20)
    starts = np.asarray([0, 13, 19])
    want = jax.vmap(lambda r, st: jax.lax.dynamic_slice_in_dim(r, st, 8, 0))(
        jnp.asarray(src), jnp.asarray(starts))
    got = tpe._chunk_rows(torch.from_numpy(src), torch.from_numpy(starts), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
