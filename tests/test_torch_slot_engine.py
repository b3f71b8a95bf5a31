"""The port's slot engine (``serve/engine.py``'s ``ServingEngine``: a dense
KV cache per slot) against the JAX one (CPU, tiny DS config with GQA, f32,
weights bridged by ``checkpoint.from_jax_params``).

Mirrors every test of tests/test_engine.py that is not marked slow. Greedy
tokens must equal the JAX engine's and the port's own ``generate`` (exact:
two f32 implementations agree unless two logits tie to ~1e-6). Sampling
rows draw from the port's own generator, so they are checked for their
length and their ids only.
"""

import jax
import numpy as np
import pytest
import torch

from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.constants import DEPTH_TOKEN_INDEX, IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.serve.engine import ServingEngine as JEngine
from vcoder_tpu_torch import generation as tgen
from vcoder_tpu_torch.checkpoint import from_jax_params
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.serve.engine import ServingEngine as TEngine

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    assert jcfg.text.num_kv_heads < jcfg.text.num_heads
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    hw = jcfg.vision.image_size
    px = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, hw, hw, 3)))
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, px=px)


def _prompt(i, with_depth=True):
    base = [1, 10 + i, 11, IMAGE_TOKEN_INDEX]
    base += [DEPTH_TOKEN_INDEX, SEG_TOKEN_INDEX] if with_depth else [SEG_TOKEN_INDEX]
    return base + [12, 13 + i]


def _engine(s, jax_side: bool, params=None, **kw):
    kw = {"max_batch": 2, "max_len": 768, "attn_impl": "xla", **kw}
    if jax_side:
        return JEngine(s["jcfg"], s["jp"] if params is None else params, **kw)
    return TEngine(s["tcfg"], s["tp"] if params is None else params, device="cpu", **kw)


def _serve(eng, s, n, max_new, **req):
    px = s["px"]
    rids = [eng.add_request(_prompt(i), images=px, segs=px, depths=px, max_new_tokens=max_new,
                            **req) for i in range(n)]
    res = eng.run()
    return [res[r] for r in rids]


def _both(s, n, max_new, **kw):
    """The same requests through the JAX engine and the port's; the two
    outputs must be equal."""
    ref = _serve(_engine(s, True, **kw), s, n, max_new)
    got = _serve(_engine(s, False, **kw), s, n, max_new)
    assert got == ref
    return got


def _generate(s, i, max_new, params=None):
    px = torch.as_tensor(s["px"])
    res = tgen.generate(s["tp"] if params is None else params, s["tcfg"], [_prompt(i)], px, px,
                        px, max_new_tokens=max_new, temperature=0.0, attn_impl="xla", pad_to=512)
    return [int(t) for t in res.sequences[0][: int(res.num_generated[0])]]


def _valid(s, toks, max_new):
    assert 1 <= len(toks) <= max_new
    assert all(0 <= t < s["tcfg"].text.vocab_size for t in toks)


def test_engine_matches_fused_generate(setup):
    out = _both(setup, 1, 6)
    assert out[0] == _generate(setup, 0, 6)


def test_engine_concurrent_requests_and_slot_reuse(setup):
    """4 requests through 2 slots: queueing and slot reuse; each request's
    tokens equal its solo ``generate`` run and the JAX engine's."""
    out = _both(setup, 4, 4)
    for i in range(4):
        assert out[i] == _generate(setup, i, 4), f"request {i}"


def test_slot_reuse_resets_the_row(setup):
    """A reused slot keeps nothing of its last tenant: after a longer request
    leaves the one slot, the next one's row marks exactly its own prompt and
    first token, and its tokens equal ``generate``'s."""
    s = setup
    eng = _engine(s, False, max_batch=1)
    px = s["px"]
    eng.add_request(_prompt(0), images=px, segs=px, depths=px, max_new_tokens=12)
    second = eng.add_request(_prompt(1), images=px, segs=px, depths=px, max_new_tokens=4)
    while eng.slots[0] is None or eng.slots[0].request_id != second:
        eng.step()
    req = eng.slots[0]
    used = req.context_used() - 1  # the newest token's K/V is written by the next step
    row = eng.cache.kv_mask[0]
    assert row[:used].all() and not row[used:].any()
    assert int(eng.cache.length[0]) == used
    eng.run()
    assert req.generated == _generate(s, 1, 4)
    eng.close()
    assert eng.cache is None


def test_int4_engine_matches_fused_generate(setup):
    """int4 weights (the plain version of K5 on the CPU): the slot engine's
    tokens equal ``generate``'s on the same weights and the JAX slot
    engine's."""
    from vcoder_tpu.quant import quantize_params

    s = setup
    jq4 = quantize_params(s["jp"], bits=4, destroy=False)
    tq4 = from_jax_params(jax.tree.map(np.asarray, jq4), s["tcfg"], device="cpu")
    ref = _serve(_engine(s, True, params=jq4), s, 1, 5)
    got = _serve(_engine(s, False, params=tq4), s, 1, 5)
    assert got == ref
    assert got[0] == _generate(s, 0, 5, params=tq4)


def test_engine_mixed_modalities(setup):
    s = setup
    outs = []
    for jax_side in (True, False):
        eng = _engine(s, jax_side)
        px = s["px"]
        r1 = eng.add_request(_prompt(0), images=px, segs=px, depths=px, max_new_tokens=3)
        r2 = eng.add_request(_prompt(1, with_depth=False), images=px, segs=px, max_new_tokens=3)
        r3 = eng.add_request([1, 5, 6, 7], max_new_tokens=3)  # text-only
        res = eng.run()
        assert set(res) == {r1, r2, r3}
        outs.append([res[r] for r in (r1, r2, r3)])
    assert outs[1] == outs[0]


def test_engine_temperature_sampling(setup):
    eng = _engine(setup, False, seed=7)
    (toks,) = _serve(eng, setup, 1, 8, temperature=1.5)
    _valid(setup, toks, 8)


# ---- speculative continuous batching -------------------------------------


def test_spec_engine_matches_plain_greedy(setup):
    s = setup
    spec = _engine(s, False, speculative=6)
    assert spec.cache.k.shape[2] == 768 + 6  # lookahead slack
    got = _serve(spec, s, 3, 7)  # 3 requests through 2 slots: slot reuse
    assert got == _serve(_engine(s, False), s, 3, 7)
    assert got == _serve(_engine(s, True, speculative=6), s, 3, 7)


def test_spec_engine_accepts_on_cyclic_output(setup):
    """Tiny models greedily loop; once the history holds a period the drafts
    verify and a step emits more than one token."""
    s = setup
    spec = _engine(s, False, max_batch=1, speculative=8)
    px = s["px"]
    rid = spec.add_request(_prompt(0), images=px, segs=px, depths=px, max_new_tokens=48)
    dispatches, events = 0, []
    while spec.has_work():
        before = len(events)
        events.extend(spec.step())
        if len(events) > before or spec.active.any():
            dispatches += 1
    assert len(events) >= 8
    if len(events) >= 32:
        assert dispatches < len(events), f"{dispatches} dispatches for {len(events)} tokens"
    toks = [t for r, t, _ in events if r == rid]
    assert toks == _serve(_engine(s, True, max_batch=1, speculative=8), s, 1, 48)[0]


def test_spec_engine_mixed_temperature(setup):
    """A sampling row rides the verify step and emits one token a step; the
    greedy row still matches the plain engine's."""
    s = setup
    outs = {}
    for name, kw in (("plain", {}), ("spec", {"speculative": 4})):
        eng = _engine(s, False, seed=7, **kw)
        px = s["px"]
        g = eng.add_request(_prompt(0), images=px, segs=px, depths=px, max_new_tokens=6)
        smp = eng.add_request(_prompt(1), images=px, segs=px, depths=px, max_new_tokens=6,
                              temperature=0.8)
        res = eng.run()
        outs[name] = res[g]
        _valid(s, res[smp], 6)
    assert outs["spec"] == outs["plain"] == _generate(s, 0, 6)


def test_sync_every_matches_per_step(setup):
    """sync_every=4 (4 single steps, one host read): the per-step tokens,
    4 requests through 2 slots (reuse under windows), and the JAX windowed
    engine's."""
    s = setup
    win = _both(s, 4, 7, sync_every=4)
    assert win == _serve(_engine(s, False), s, 4, 7)


def test_spec_fused_matches_plain(setup):
    """Fused speculative windows (speculative=5, sync_every=3: drafting from
    the device histories) emit the plain engine's tokens and the JAX fused
    engine's."""
    s = setup
    fused = _engine(s, False, speculative=5, sync_every=3)
    assert fused._spec_fused and fused.cache.k.shape[2] == 768 + 5
    got = _serve(fused, s, 4, 9)
    assert got == _serve(_engine(s, False), s, 4, 9)
    assert got == _serve(_engine(s, True, speculative=5, sync_every=3), s, 4, 9)


def test_sync_every_window_strategies(setup):
    """int8 weights and f32 weights: windowed decode equals per-step decode
    (the JAX package's serving relayout has no counterpart here)."""
    from vcoder_tpu.quant import quantize_params

    s = setup
    jq8 = quantize_params(s["jp"], bits=8, destroy=False)
    tq8 = from_jax_params(jax.tree.map(np.asarray, jq8), s["tcfg"], device="cpu")
    for jp, tp in ((jq8, tq8), (s["jp"], s["tp"])):
        ref = _serve(_engine(s, False, params=tp), s, 3, 7)
        assert _serve(_engine(s, False, params=tp, sync_every=4), s, 3, 7) == ref
        assert _serve(_engine(s, True, params=jp, sync_every=4), s, 3, 7) == ref


def test_engine_top_p_near_zero_is_greedy(setup):
    """top_p -> 0 keeps only the argmax: a sampling request with a tiny top_p
    emits the greedy tokens."""
    s = setup
    eng = _engine(s, False, seed=11)
    px = s["px"]
    t = eng.add_request(_prompt(0), images=px, segs=px, depths=px, max_new_tokens=6,
                        temperature=0.9, top_p=1e-9)
    eng.step()  # admits the request
    assert eng._nucleus()
    assert eng.run()[t] == _serve(_engine(s, False), s, 1, 6)[0] == _generate(s, 0, 6)


def test_engine_top_p_mixed_rows(setup):
    """A tiny-top_p sampling row beside an unrestricted one: only the
    restricted row reduces to greedy."""
    s = setup
    eng = _engine(s, False, seed=5)
    px = s["px"]
    a = eng.add_request(_prompt(0), images=px, segs=px, depths=px, max_new_tokens=5,
                        temperature=1.3, top_p=1e-9)
    b = eng.add_request(_prompt(1), images=px, segs=px, depths=px, max_new_tokens=5,
                        temperature=1.3, top_p=1.0)
    res = eng.run()
    assert res[a] == _generate(s, 0, 5)
    _valid(s, res[b], 5)


def test_spec_engine_top_p(setup):
    """Sampling rows inside a speculative verify step honour top_p."""
    s = setup
    eng = _engine(s, False, speculative=4, seed=2)
    got = _serve(eng, s, 1, 6, temperature=0.8, top_p=1e-9)[0]
    assert got == _generate(s, 0, 6)


def test_spec_fused_mixed_temperature(setup):
    s = setup
    eng = _engine(s, False, speculative=4, sync_every=2, seed=3)
    px = s["px"]
    g = eng.add_request(_prompt(0), images=px, segs=px, depths=px, max_new_tokens=6)
    smp = eng.add_request(_prompt(1), images=px, segs=px, depths=px, max_new_tokens=6,
                          temperature=0.9)
    res = eng.run()
    assert res[g] == _generate(s, 0, 6)
    _valid(s, res[smp], 6)


def test_mesh_still_raises(setup):
    """A mesh of two devices without a process group still raises; over a
    spawned group of two ranks the engine serves the one-device tokens."""
    class Mesh:
        size = 2

    with pytest.raises(NotImplementedError, match="mesh.*torch.distributed.run"):
        TEngine(setup["tcfg"], setup["tp"], device="cpu", mesh=Mesh())
    from tests.test_torch_sharding import engine_rank, tiny_params
    from vcoder_tpu_torch.parallel import launch

    cfg, params = tiny_params()
    S = cfg.vision.image_size
    px = np.random.RandomState(2).randn(1, S, S, 3).astype(np.float32)
    reqs = [([1, 10 + i, 11, -200, -400, -300, 12, 13 + i], px, 5) for i in range(3)]
    one = TEngine(cfg, params, max_batch=2, max_len=256, attn_impl="xla", device="cpu",
                  kv_quant=True)
    rids = [one.add_request(ids, images=p, segs=p, depths=p, max_new_tokens=n)
            for ids, p, n in reqs]
    want = one.run()
    ranks = launch.spawn(engine_rank, 2, "slot", (2, 1, 1), reqs,
                         {"max_batch": 2, "kv_quant": True}, timeout_s=120)
    assert ranks == [[want[r] for r in rids]] * 2
