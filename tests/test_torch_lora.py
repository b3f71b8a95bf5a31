"""LoRA and multi-LoRA serving: the port (``vcoder_tpu_torch/lora.py``, the
engines, the ``model_base`` loaders) against the JAX package on the CPU.

Mirrors tests/test_multilora.py and tests/test_lora.py. Adapters are made
with numpy and handed to both packages (``jax.random`` and ``torch`` draw
different numbers). The engine tests run the paged engine, and the slot
engine on one mixed batch. f32 throughout: products agree to 1e-5, greedy tokens
exactly; merged checkpoint weights to 1e-6 (the f32 products ``B @ A`` of
numpy and torch may differ in the last bit).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu import builder as jbuilder
from vcoder_tpu import lora as jlora
from vcoder_tpu import quant as jquant
from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.constants import IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.multimodal import build_splice_plan as jplan
from vcoder_tpu.ops import quant as jq
from vcoder_tpu.serve import paged_engine as jpe
from vcoder_tpu_torch import lora as tlora
from vcoder_tpu_torch.builder import load_pretrained_model
from vcoder_tpu_torch.checkpoint import from_jax_params, save_pretrained, write_safetensors
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.models import vcoder as tvcoder
from vcoder_tpu_torch.multimodal import build_splice_plan as tplan
from vcoder_tpu_torch.ops import quant as tq
from vcoder_tpu_torch.ops.quant import QuantizedTensor
from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine
from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer
from vcoder_tpu_torch.tree import named_leaves

torch.set_num_threads(1)

TARGETS = ["lm/layers/q_proj", "lm/layers/v_proj", "lm/layers/down_proj"]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _get(tree, path):
    for part in path.split("/"):
        tree = tree[part]
    return tree


@pytest.fixture(scope="module")
def setup():
    base = JConfig.tiny("vcoder_llava")
    jcfg = dataclasses.replace(base, text=dataclasses.replace(base.text, num_kv_heads=4))
    tbase = TConfig.tiny("vcoder_llava")
    tcfg = dataclasses.replace(tbase, text=dataclasses.replace(tbase.text, num_kv_heads=4))
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.RandomState(11)

    def mk_adapter(rank, alpha):
        tree = {}
        for path in TARGETS:
            L, in_dim, out_dim = _get(jp, path).shape
            a = (rng.randn(L, in_dim, rank) * 0.1).astype(np.float32)
            b = (rng.randn(L, rank, out_dim) * 0.1).astype(np.float32)
            tree[path] = (a, b, float(alpha) / rank)
        return tree

    adapters = {"x": mk_adapter(4, 8.0), "y": mk_adapter(8, 8.0)}
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, np_adapters=adapters,
                jad={n: {p: (jnp.asarray(a), jnp.asarray(b), s) for p, (a, b, s) in t.items()}
                     for n, t in adapters.items()},
                tad={n: {p: (_t(a), _t(b), s) for p, (a, b, s) in t.items()}
                     for n, t in adapters.items()})


def _wrap_single(params, tree, cls):
    """``params`` with ONE adapter as LoraWeight leaves (the single-LoRA
    path, the numerical oracle of the mixed batch)."""
    out = dict(params)
    out["lm"] = dict(params["lm"], layers=dict(params["lm"]["layers"]))
    for path, (a, b, scale) in tree.items():
        name = path.split("/")[-1]
        out["lm"]["layers"][name] = cls(base=out["lm"]["layers"][name], a=a, b=b, scale=scale)
    return out


def _prompt(tail):
    return [1] + [20 + (j % 50) for j in range(24)] + list(tail)


def _serve(eng, jobs, max_new=6):
    rids = [eng.add_request(p, max_new_tokens=max_new, lora=name) for p, name in jobs]
    res = eng.run()
    return [res[r] for r in rids]


KW = dict(max_batch=4, max_len=256, page_size=8, attn_impl="xla")


# ---------------------------------------------------------------------------
# Products
# ---------------------------------------------------------------------------


def test_lora_qmatmul_math_matches_jax():
    rng = np.random.RandomState(0)
    w, a, b = rng.randn(16, 8), rng.randn(16, 2), rng.randn(2, 8)
    x = rng.randn(4, 16)
    w, a, b, x = (v.astype(np.float32) for v in (w, a, b, x))
    ref = np.asarray(jlora.lora_qmatmul(jnp.asarray(x), jlora.LoraWeight(
        base=jnp.asarray(w), a=jnp.asarray(a), b=jnp.asarray(b), scale=0.5)))
    out = tq.qmatmul(_t(x), tlora.LoraWeight(base=_t(w), a=_t(a), b=_t(b), scale=0.5))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), x @ w + 0.5 * (x @ a @ b), atol=1e-5)


@pytest.mark.parametrize("bits", [0, 8, 4], ids=["plain", "int8", "int4"])
def test_lora_and_multilora_qmatmul_match_jax(setup, bits):
    """One adapter as a LoraWeight and stacked as a MultiLoraWeight (index
    0 the zero adapter, rank padded to 8) over a plain, int8 or int4 base."""
    a, b, scale = setup["np_adapters"]["x"]["lm/layers/q_proj"]
    r, in_dim, out_dim = a.shape[-1], a.shape[1], b.shape[-1]
    rng = np.random.RandomState(3)
    base = rng.randn(in_dim, out_dim).astype(np.float32)
    x = rng.randn(3, 2, in_dim).astype(np.float32)
    if bits:
        jbase = jq.quantize(jnp.asarray(base), bits=bits)
        tbase = QuantizedTensor(_t(jbase.q), _t(jbase.scale), bits)
    else:
        jbase, tbase = jnp.asarray(base), _t(base)
    R = 8
    a_p = np.pad(a[0], ((0, 0), (0, R - r)))
    b_p = np.pad(b[0] * scale, ((0, R - r), (0, 0)))
    stacks = (np.stack([np.zeros_like(a_p), a_p]), np.stack([np.zeros_like(b_p), b_p]))
    idx = np.asarray([1, 0, 1], np.int32)
    single_j = jlora.lora_qmatmul(jnp.asarray(x), jlora.LoraWeight(
        base=jbase, a=jnp.asarray(a[0]), b=jnp.asarray(b[0]), scale=scale))
    multi_j = jlora.multilora_qmatmul(jnp.asarray(x), jlora.MultiLoraWeight(
        base=jbase, a=jnp.asarray(stacks[0]), b=jnp.asarray(stacks[1]), idx=jnp.asarray(idx)))
    single_t = tq.qmatmul(_t(x), tlora.LoraWeight(base=tbase, a=_t(a[0]), b=_t(b[0]),
                                                  scale=scale))
    multi_t = tq.qmatmul(_t(x), tlora.MultiLoraWeight(base=tbase, a=_t(stacks[0]),
                                                      b=_t(stacks[1]), idx=_t(idx)))
    np.testing.assert_allclose(single_t.numpy(), np.asarray(single_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(multi_t.numpy(), np.asarray(multi_j), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(multi_t[0].numpy(), single_t[0].numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(multi_t[1].numpy(), tq.qmatmul(_t(x[1]), tbase).numpy(),
                               atol=1e-5, rtol=1e-5)  # index 0: the base alone
    assert tq.base_weight_dtype(tlora.LoraWeight(tbase, _t(a[0]), _t(b[0]), scale)) == (
        tq.base_weight_dtype(tbase))


# ---------------------------------------------------------------------------
# Stacks, views, row adapters
# ---------------------------------------------------------------------------


def test_stack_and_view_match_jax(setup):
    wrapped_j, ids_j = jlora.stack_adapters(setup["jp"], setup["jad"], max_batch=4)
    wrapped, ids = tlora.stack_adapters(setup["tp"], setup["tad"], max_batch=4)
    assert ids == ids_j == {"x": 1, "y": 2}
    for path in TARGETS:
        q, qj = _get(wrapped, path), _get(wrapped_j, path)
        assert isinstance(q, tlora.MultiLoraWeight)
        assert q.a.shape == qj.a.shape and q.a.shape[1] == 3 and q.a.shape[-1] == 8
        np.testing.assert_allclose(q.a.numpy(), np.asarray(qj.a), rtol=0, atol=0)
        np.testing.assert_allclose(q.b.numpy(), np.asarray(qj.b), rtol=1e-7, atol=0)
        assert q.idx.shape == (q.a.shape[0], 4) and q.idx.dtype == torch.int32
        assert not q.a[:, 0].any() and not q.b[:, 0].any()  # the zero adapter
    assert wrapped["lm"]["layers"]["k_proj"] is setup["tp"]["lm"]["layers"]["k_proj"]
    view = tlora.single_adapter_view(wrapped, 0)
    vq = view["lm"]["layers"]["q_proj"]
    assert isinstance(vq, tlora.LoraWeight) and not vq.a.any() and vq.scale == 1.0
    # Paths of a wrapped tree follow the JAX package's (dataclass fields).
    paths = {p for p, _ in named_leaves(wrapped)}
    assert {"lm/layers/q_proj/base", "lm/layers/q_proj/a", "lm/layers/q_proj/idx"} <= paths


def test_set_row_adapter_writes_in_place(setup):
    wrapped, _ = tlora.stack_adapters(setup["tp"], setup["tad"], max_batch=4)
    q = wrapped["lm"]["layers"]["q_proj"]
    layer0 = q[0]  # a layer slice is a view of the index
    assert tlora.set_row_adapter(wrapped, 2, 1) is wrapped
    tlora.set_row_adapter(wrapped, 3, 2)
    for path in TARGETS:
        assert _get(wrapped, path).idx.tolist() == [[0, 0, 1, 2]] * q.idx.shape[0]
    assert layer0.idx.tolist() == [0, 0, 1, 2]
    tlora.set_row_adapter(wrapped, 2, 0)
    assert layer0.idx.tolist() == [0, 0, 0, 2]


@pytest.mark.parametrize("case", ["partial_layer", "no_target", "empty", "out_dim", "base_2d"])
def test_stack_adapters_rejections(setup, case):
    x = setup["tad"]["x"]
    if case == "partial_layer":
        bad, match = {"x": {p: (a[:1], b[:1], s) for p, (a, b, s) in x.items()}}, "stacked over"
        params = setup["tp"]
    elif case == "no_target":
        bad = {"x": x, "g": {"lm/layers/nonexistent_proj": next(iter(x.values()))}}
        match, params = "targets no parameter", setup["tp"]
    elif case == "empty":
        bad, match, params = {"e": {}}, "no LoRA targets", setup["tp"]
    elif case == "out_dim":
        params = {"lm": {"layers": {"q_proj": torch.ones(2, 8, 8)}}}
        bad = {"x": {"lm/layers/q_proj": (torch.ones(2, 8, 4), torch.ones(2, 4, 16), 1.0)}}
        match = "out_dim"
    else:
        params = {"lm": {"lm_head": torch.ones(8, 8)}}
        bad = {"x": {"lm/lm_head": (torch.ones(8, 4), torch.ones(4, 8), 1.0)}}
        match = "layer-stacked"
    with pytest.raises(ValueError, match=match):
        tlora.stack_adapters(params, bad, max_batch=4)


def test_adapter_scale_add_lora_and_merge():
    assert tlora.adapter_scale({"r": 8, "lora_alpha": 16}) == 2.0
    assert tlora.adapter_scale({"r": 16, "lora_alpha": 32, "use_rslora": True}) == 8.0
    with pytest.raises(ValueError, match="rank_pattern"):
        tlora.adapter_scale({"r": 8, "lora_alpha": 16, "rank_pattern": {"q": 4}})
    params = {"lm": {"layers": {"q_proj": torch.ones(2, 8, 8), "norm": torch.ones(2, 8)}}}
    gen = torch.Generator().manual_seed(0)
    once = tlora.add_lora(params, gen, rank=4)
    twice = tlora.add_lora(once, gen, rank=4)
    w = twice["lm"]["layers"]["q_proj"]
    assert isinstance(w, tlora.LoraWeight) and not isinstance(w.base, tlora.LoraWeight)
    assert w.a.shape == (2, 8, 4) and not w.b.any() and w.scale == 256.0 / 4
    assert twice["lm"]["layers"]["norm"] is params["lm"]["layers"]["norm"]
    # B = 0: the identity; the merged weight equals the wrapped product.
    x = torch.randn(3, 8, generator=gen)
    assert torch.equal(tq.qmatmul(x, w[0]), x @ params["lm"]["layers"]["q_proj"][0])
    w.b = torch.randn(w.b.shape, generator=gen) * 0.1
    merged = tlora.merge_lora(twice)["lm"]["layers"]["q_proj"]
    np.testing.assert_allclose((x @ merged[0]).numpy(), tq.qmatmul(x, w[0]).numpy(), atol=1e-5)
    # Over an int8 base: bf16 adapters, dequantized merge.
    q8 = tlora.add_lora({"lm": {"layers": {"q_proj": tq.quantize(torch.randn(2, 8, 8))}}}, gen,
                        rank=4)["lm"]["layers"]["q_proj"]
    assert isinstance(q8.base, QuantizedTensor) and q8.a.dtype == torch.bfloat16
    assert torch.isfinite(tq.qmatmul(x, q8[1])).all()


def test_lora_over_int8_base_prefill_matches_jax(setup):
    """JAX LoraWeight leaves over a JAX-quantized int8 base, carried across by
    ``from_jax_params``: the same prefill logits."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jq8 = jquant.quantize_params(setup["jp"], bits=8, destroy=False)
    jl = _wrap_single(jq8, setup["jad"]["x"], jlora.LoraWeight)
    tl = from_jax_params(jax.tree.map(np.asarray, jl), tcfg, device="cpu")
    assert isinstance(tl["lm"]["layers"]["q_proj"], tlora.LoraWeight)
    assert isinstance(tl["lm"]["layers"]["q_proj"].base, QuantizedTensor)
    ids = [[1, 5, 6, IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX, 7, 8]]
    hw = jcfg.vision.image_size
    px = np.random.RandomState(1).randn(1, hw, hw, 3).astype(np.float32)
    kw = dict(num_patches=jcfg.vision.num_patches, has_seg=True, pad_multiple=16)
    lj, _ = jvcoder.prefill(jl, jcfg, jvcoder.plan_to_arrays(jplan(ids, **kw)), jnp.asarray(px),
                            jnp.asarray(px), use_vcoder_emb=True, attn_impl="xla")
    lt, _ = tvcoder.prefill(tl, tcfg, tvcoder.plan_to_arrays(tplan(ids, **kw), "cpu"), _t(px),
                            _t(px), use_vcoder_emb=True, attn_impl="xla")
    lj = np.asarray(lj)
    np.testing.assert_allclose(lt.numpy(), lj, atol=1e-4 * np.abs(lj).max(), rtol=0)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


JOBS = [(_prompt([5, 9]), "x"), (_prompt([5, 9]), "y"), (_prompt([5, 9]), None),
        (_prompt([7, 3]), "x")]


def test_mixed_batch_matches_single_adapter_engines_and_jax(setup):
    s = setup
    mixed = _serve(PagedServingEngine(s["tcfg"], s["tp"], lora_adapters=s["tad"], device="cpu",
                                      **KW), JOBS)
    jmixed = _serve(jpe.PagedServingEngine(s["jcfg"], s["jp"], lora_adapters=s["jad"], **KW), JOBS)
    assert mixed == jmixed

    def single(name, prompts):
        params = s["tp"] if name is None else _wrap_single(s["tp"], s["tad"][name],
                                                           tlora.LoraWeight)
        eng = PagedServingEngine(s["tcfg"], params, device="cpu", **KW)
        return _serve(eng, [(p, None) for p in prompts])

    ox = single("x", [JOBS[0][0], JOBS[3][0]])
    assert mixed[0] == ox[0] and mixed[3] == ox[1]
    assert mixed[1] == single("y", [JOBS[1][0]])[0]
    assert mixed[2] == single(None, [JOBS[2][0]])[0]
    assert len({tuple(m) for m in mixed[:3]}) == 3  # adapters change tokens


@pytest.mark.parametrize("kw", [{}, {"kv_quant": True, "speculative": 3, "sync_every": 2}],
                         ids=["bf16", "int8_fused_spec"])
def test_slot_engine_mixed_batch_matches_jax(setup, kw):
    """The slot engine serves the same mixed batch (rows x, y, none, x) as the
    JAX slot engine, with a bf16-layout cache and with an int8 cache under
    fused speculative windows; its rows equal the paged engine's."""
    from vcoder_tpu.serve.engine import ServingEngine as JSlot
    from vcoder_tpu_torch.serve.engine import ServingEngine as TSlot

    s = setup
    skw = dict(max_batch=4, max_len=256, attn_impl="xla", **kw)
    got = _serve(TSlot(s["tcfg"], s["tp"], lora_adapters=s["tad"], device="cpu", **skw), JOBS)
    assert got == _serve(JSlot(s["jcfg"], s["jp"], lora_adapters=s["jad"], **skw), JOBS)
    if not kw:
        assert got == _serve(PagedServingEngine(s["tcfg"], s["tp"], lora_adapters=s["tad"],
                                                device="cpu", **KW), JOBS)


def test_speculative_int8_pools_multilora_matches_jax(setup):
    s = setup
    kw = dict(KW, speculative=4, kv_quant=True)
    out = _serve(PagedServingEngine(s["tcfg"], s["tp"], lora_adapters=s["tad"], device="cpu",
                                    **kw), JOBS)
    ref = _serve(jpe.PagedServingEngine(s["jcfg"], s["jp"], lora_adapters=s["jad"], **kw), JOBS)
    assert out == ref


def test_slot_reuse_resets_adapter(setup):
    s = setup
    kw = dict(KW, max_batch=1)
    eng = PagedServingEngine(s["tcfg"], s["tp"], lora_adapters=s["tad"], device="cpu", **kw)
    out = _serve(eng, [(_prompt([5, 9]), "x"), (_prompt([5, 9]), None)])
    plain = _serve(PagedServingEngine(s["tcfg"], s["tp"], device="cpu", **kw),
                   [(_prompt([5, 9]), None)])
    assert out[1] == plain[0] and out[0] != out[1]


def test_unknown_adapter_and_lora_on_plain_engine_fail_only_that_request(setup):
    s = setup
    eng = PagedServingEngine(s["tcfg"], s["tp"], lora_adapters=s["tad"], device="cpu", **KW)
    ok = eng.add_request(_prompt([5, 9]), max_new_tokens=4, lora="x")
    bad = eng.add_request(_prompt([5, 9]), max_new_tokens=4, lora="nope")
    res = eng.run()
    assert len(res[ok]) == 4 and res[bad] == []
    assert "unknown LoRA adapter" in eng.pop_error(bad)
    plain = PagedServingEngine(s["tcfg"], s["tp"], device="cpu", **KW)
    rid = plain.add_request(_prompt([5, 9]), max_new_tokens=4, lora="x")
    assert plain.run()[rid] == [] and "no LoRA adapters" in plain.pop_error(rid)


def test_prefix_cache_is_adapter_salted(setup):
    s = setup
    kw = dict(KW, max_batch=2, prefix_cache=True, prefix_chunk=16)
    eng = PagedServingEngine(s["tcfg"], s["tp"], lora_adapters=s["tad"], device="cpu", **kw)
    out = _serve(eng, [(_prompt([5, 9]), "x"), (_prompt([5, 9]), "y")])
    assert eng.prefix_stats()["hits"] == 0
    oracle_y = _serve(PagedServingEngine(s["tcfg"], _wrap_single(s["tp"], s["tad"]["y"],
                                                                 tlora.LoraWeight),
                                         device="cpu", **dict(KW, max_batch=2)),
                      [(_prompt([5, 9]), None)])
    assert out[1] == oracle_y[0]
    out2 = _serve(eng, [(_prompt([5, 9]), "x")])
    assert eng.prefix_stats()["hits"] >= 1 and out2[0] == out[0]


def test_chunked_prefill_multilora_matches_jax(setup):
    s = setup
    jobs = [(_prompt([5, 9]), "x"), (_prompt([7, 3]), "y"), (_prompt([7, 3]), None)]
    kw = dict(KW, chunked_prefill=16)
    eng = PagedServingEngine(s["tcfg"], s["tp"], lora_adapters=s["tad"], device="cpu", **kw)
    eng.warmup_chunks(vision=False)  # the zero adapter's view at every group bucket
    chunked = _serve(eng, jobs)
    plain = _serve(PagedServingEngine(s["tcfg"], s["tp"], lora_adapters=s["tad"], device="cpu",
                                      **KW), jobs)
    ref = _serve(jpe.PagedServingEngine(s["jcfg"], s["jp"], lora_adapters=s["jad"], **kw), jobs)
    assert chunked == plain == ref


# ---------------------------------------------------------------------------
# Adapter directories and checkpoints over a base
# ---------------------------------------------------------------------------


def _peft_state(rng, L, shapes, prefix="base_model.model.model.layers"):
    state = {}
    for i in range(L):
        for mod, proj, in_dim, out_dim, r in shapes:
            pre = f"{prefix}.{i}.{mod}.{proj}"
            state[f"{pre}.lora_A.weight"] = torch.from_numpy(rng.randn(r, in_dim)
                                                             .astype(np.float32))
            state[f"{pre}.lora_B.weight"] = torch.from_numpy(rng.randn(out_dim, r)
                                                             .astype(np.float32))
    return state


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_load_lora_adapter_dir_matches_jax(tmp_path, fmt):
    rng = np.random.RandomState(0)
    state = _peft_state(rng, 2, [("self_attn", "q_proj", 8, 12, 4), ("mlp", "down_proj", 12, 8, 4)])
    if fmt == "bin":
        torch.save(state, str(tmp_path / "adapter_model.bin"))
    else:
        write_safetensors(str(tmp_path / "adapter_model.safetensors"), state)
    (tmp_path / "adapter_config.json").write_text(json.dumps({"lora_alpha": 16, "r": 4}))
    tree = tlora.load_lora_adapter_dir(str(tmp_path))
    ref = jlora.load_lora_adapter_dir(str(tmp_path))
    assert sorted(tree) == sorted(ref) == ["lm/layers/down_proj", "lm/layers/q_proj"]
    for path in tree:
        for got, want in zip(tree[path][:2], ref[path][:2]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tree[path][2] == ref[path][2] == 4.0
    a = tree["lm/layers/q_proj"][0]
    assert a.shape == (2, 8, 4)
    np.testing.assert_array_equal(
        a[0].numpy(), state["base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight"]
        .numpy().T)


def test_adapter_dir_ab_layer_mismatch(tmp_path):
    z = lambda *s: torch.zeros(s)  # noqa: E731
    write_safetensors(str(tmp_path / "adapter_model.safetensors"), {
        "base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight": z(4, 8),
        "base_model.model.model.layers.1.self_attn.q_proj.lora_A.weight": z(4, 8),
        "base_model.model.model.layers.0.self_attn.q_proj.lora_B.weight": z(8, 4),
    })
    with pytest.raises(ValueError, match="different"):
        tlora.load_lora_adapter_dir(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        tlora.load_lora_adapter_dir(str(tmp_path / "missing"))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A tiny DS base checkpoint, a PEFT LoRA directory over it (with
    ``non_lora_trainables.bin`` in the reference's doubly-prefixed keys) and
    an adapter-only directory (projector weights under bare,
    'base_model.model.' and 'model.' prefixes)."""
    root = tmp_path_factory.mktemp("ckpt")
    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(4), jcfg)
    tp = from_jax_params(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tok = SimpleTokenizer({"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3})
    base = str(root / "vcoder_ds_llava-tiny-base")
    save_pretrained(base, tp, tcfg)
    tok.save_pretrained(base)
    rng = np.random.RandomState(5)
    D, I, L = tcfg.text.hidden_size, tcfg.text.intermediate_size, tcfg.text.num_layers
    H = tcfg.text.num_heads * tcfg.text.head_dim
    KV = tcfg.text.num_kv_heads * tcfg.text.head_dim
    lora_dir = root / "vcoder_ds_llava-tiny-lora"
    lora_dir.mkdir()
    state = _peft_state(rng, L, [("self_attn", "q_proj", D, H, 4), ("self_attn", "v_proj", D, KV, 4),
                                 ("mlp", "down_proj", I, D, 4)])
    write_safetensors(str(lora_dir / "adapter_model.safetensors"), state)
    (lora_dir / "adapter_config.json").write_text(json.dumps({"lora_alpha": 8, "r": 4}))
    f = lambda *s: torch.from_numpy((rng.randn(*s) * 0.05).astype(np.float32))  # noqa: E731
    mm = tp["mm_projector"]["w"][0].shape
    torch.save({"base_model.model.model.mm_projector.0.weight": f(mm[1], mm[0]),
                "base_model.model.model.vcoder_lm_emb.weight": f(tcfg.text.vocab_size, D)},
               str(lora_dir / "non_lora_trainables.bin"))
    with open(os.path.join(base, "config.json")) as src:
        cfg_text = src.read()
    (lora_dir / "config.json").write_text(cfg_text)
    tok.save_pretrained(str(lora_dir))
    adapter_dir = root / "vcoder_ds_llava-tiny-adapter"
    adapter_dir.mkdir()
    seg = tp["seg_projector"]["w"][0].shape
    write_safetensors(str(adapter_dir / "mm_projector.safetensors"), {
        "model.mm_projector.0.weight": f(mm[1], mm[0]),
        "base_model.model.model.seg_mm_projector.0.weight": f(seg[1], seg[0]),
        "mm_projector.0.bias": f(mm[1]),
    })
    (adapter_dir / "config.json").write_text(cfg_text)
    tok.save_pretrained(str(adapter_dir))
    return dict(base=base, lora=str(lora_dir), adapter=str(adapter_dir), tcfg=tcfg, tp=tp)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("kind", ["lora", "adapter"])
def test_load_pretrained_model_over_a_base_matches_jax(checkpoints, kind):
    c = checkpoints
    tok, model, proc, seg_proc, depth_proc, ctx = load_pretrained_model(
        c[kind], model_base=c["base"], device="cpu", dtype=torch.float32)
    _, jmodel, *_ = jbuilder.load_pretrained_model(c[kind], model_base=c["base"],
                                                   dtype=jnp.float32)
    assert seg_proc is not None and depth_proc is not None and tok is not None
    got, want = _flat(model.params), _flat(jmodel.params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    base = _flat(c["tp"])
    changed = {k for k in want if not np.array_equal(want[k], base[k])}
    if kind == "lora":
        assert {"/lm/layers/q_proj", "/lm/layers/v_proj", "/lm/layers/down_proj",
                "/mm_projector/w/0", "/vcoder_lm_emb"} == changed
    else:
        assert {"/mm_projector/w/0", "/mm_projector/b/0", "/seg_projector/w/0"} == changed
    res = model.generate([[1, 10, 11, 12]], max_new_tokens=3)
    assert res.sequences.shape == (1, 3)
