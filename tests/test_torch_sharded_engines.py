"""Both serving engines over a ``(data, fsdp, model)`` mesh: the port's
``ServingEngine`` and ``PagedServingEngine`` on 4 gloo ranks at mesh
``(2, 1, 2)`` (rows over ``data``, heads over ``model``) against JAX's mesh
engines on 4 of its 8 virtual CPU devices and the port's one-device engines
(CPU, tiny DS config with GQA, f32).

Six requests with RGB + seg + depth pixels through 4 slots (slots are
reused): greedy tokens equal to JAX's mesh engine (slot bf16 cache, paged
bf16 pools, int8 pools, speculative verify) and to the port's one-device
engine (those and the slot engine's int8 cache and speculative verify, and
the paged engine with ``FUSED_APPEND``, bf16 and int8 + speculative), on
every rank; every shard's free list whole again at the end (mirrors
``test_engine.py:155,275`` and ``test_paged_engine.py:303,472,665``). JAX's
``ValueError``s for the prefix cache, chunked prefill and multi-LoRA over a
mesh.

Quantized weights (``quantize_params`` at 8 and 4 bits) at mesh ``(1, 2,
2)``, so ``fsdp`` gathers each field and ``model`` splits it, with
``W8A8_MIN_TOKENS`` lowered to 16 in both packages (the prefills take the
W8A8 product, row-parallel ones reducing the row absmax and the s32
products over ``model``; the decode steps the int8 upcast and the int4
nibble split): the slot and paged engines' tokens equal the port's
one-device engines on every rank, and the paged int4 engine's equal JAX's
int4 mesh engine (mirrors ``test_paged_engine.py:339``). Exact equality:
greedy tokens of f32 implementations agree unless two logits tie to ~1e-6.
"""

import functools

import numpy as np
import pytest
import torch

from vcoder_tpu_torch.parallel import launch

torch.set_num_threads(1)

MESH = (2, 1, 2)
QMESH = (1, 2, 2)
CASES = {
    "slot": ("slot", {}),
    "slot_int8": ("slot", {"kv_quant": True}),
    "slot_spec": ("slot", {"speculative": 4}),
    "paged": ("paged", {}),
    "paged_int8": ("paged", {"kv_quant": True}),
    "paged_spec": ("paged", {"speculative": 4}),
    "paged_fused": ("paged", {"fused": True}),
    "paged_fused_int8_spec": ("paged", {"fused": True, "kv_quant": True, "speculative": 4}),
    # Quantized weights, at QMESH.
    "slot_w8": ("slot", {"bits": 8}),
    "slot_w4": ("slot", {"bits": 4}),
    "paged_w8": ("paged", {"bits": 8, "kv_quant": True}),
    "paged_w4": ("paged", {"bits": 4}),
}
JAX_CASES = ("slot", "paged", "paged_int8", "paged_spec", "paged_w4")
W8A8_MIN_TOKENS = 16


def _mesh_of(case):
    return QMESH if "bits" in CASES[case][1] else MESH


def _requests(cfg):
    S = cfg.vision.image_size
    px = np.random.RandomState(1).randn(1, S, S, 3).astype(np.float32)
    return [([1, 10 + i, 11, -200, -400, -300, 12, 13 + i] + [20 + i] * (i * 5), px)
            for i in range(6)]


def _run(engine, requests):
    rids = [engine.add_request(ids, images=px, segs=px, depths=px, max_new_tokens=6)
            for ids, px in requests]
    res = engine.run()
    return [res[r] for r in rids]


def _port_engine(np_params, case, mesh, **extra):
    from vcoder_tpu_torch.checkpoint import from_jax_params
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.quant import quantize_params
    from vcoder_tpu_torch.serve.engine import ServingEngine
    from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine

    kind, kw = CASES[case]
    kw = {k: v for k, v in kw.items() if k not in ("fused", "bits")}
    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    params = from_jax_params(np_params, cfg, device="cpu")
    if "bits" in CASES[case][1]:
        params = quantize_params(params, bits=CASES[case][1]["bits"])
    make = (functools.partial(ServingEngine, max_len=256) if kind == "slot"
            else functools.partial(PagedServingEngine, max_len=256, page_size=8))
    return make(cfg, params, max_batch=4, attn_impl="auto", device="cpu", mesh=mesh,
                **kw, **extra)


def _port_tokens(np_params, case, mesh):
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.ops import paged_attention as pa
    from vcoder_tpu_torch.ops import quant as tq

    fused = CASES[case][1].get("fused", False)
    pa.FUSED_APPEND, before = fused, pa.FUSED_APPEND
    tq.W8A8_MIN_TOKENS, min_tokens = W8A8_MIN_TOKENS, tq.W8A8_MIN_TOKENS
    w8a8 = tq.w8a8_matmul
    calls = {}
    names = ("carry_paged_attention_fused", "carry_paged_attention",
             "carry_paged_attention_q8", "carry_paged_attention_multi",
             "carry_paged_attention_multi_q8")
    saved = {n: getattr(pa, n) for n in names}

    def spy(name, fn):
        def call(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        return call

    for n in names:
        setattr(pa, n, spy(n, saved[n]))
    tq.w8a8_matmul = spy("w8a8", w8a8)
    try:
        eng = _port_engine(np_params, case, mesh)
        toks = _run(eng, _requests(VCoderConfig.tiny("vcoder_ds_llava")))
    finally:
        pa.FUSED_APPEND = before
        tq.W8A8_MIN_TOKENS, tq.w8a8_matmul = min_tokens, w8a8
        for n in names:
            setattr(pa, n, saved[n])
    free = None
    if CASES[case][0] == "paged":
        fp = eng.free_pages
        free = [len(f) for f in fp] if fp and isinstance(fp[0], list) else [len(fp)]
        free = dict(free=free, per_shard=eng.pages_per_shard, shards=eng.row_shards)
    return dict(tokens=toks, free=free, calls=calls)


def _rank_body(rank, world, np_params):
    from vcoder_tpu_torch.parallel import make_mesh
    from vcoder_tpu_torch.quant import quantize_params

    torch.set_num_threads(1)
    meshes = {s: make_mesh(data=s[0], fsdp=s[1], model=s[2]) for s in (MESH, QMESH)}
    out = {case: _port_tokens(np_params, case, meshes[_mesh_of(case)]) for case in CASES}
    errors = {}
    for name, kw in (("prefix_cache", dict(prefix_cache=True)),
                     ("chunked_prefill", dict(chunked_prefill=16)),
                     ("lora", dict(lora_adapters={"a": {}})),
                     ("lora_w8", dict(lora_adapters={"a": {}}))):
        try:
            case = "paged" if "lora" not in name else "slot_w8" if "w8" in name else "slot"
            _port_engine(np_params, case, meshes[_mesh_of(case)], **kw)
        except ValueError as e:
            errors[name] = str(e)
    # The fields of a quantized tree over the mesh: each rank's slices.
    from vcoder_tpu_torch.checkpoint import from_jax_params
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.serve.engine import ServingEngine
    from vcoder_tpu_torch.tree import named_leaves

    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    q = quantize_params(from_jax_params(np_params, cfg, device="cpu"), bits=4)
    eng = ServingEngine(cfg, q, max_batch=4, max_len=256, device="cpu", mesh=meshes[QMESH])
    out["quantized_fields"] = {p: type(t).__name__ for p, t in named_leaves(eng.params)
                               if p.startswith("lm/layers/o_proj")}
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def setup():
    import jax

    from vcoder_tpu.config import VCoderConfig as JConfig
    from vcoder_tpu.models import vcoder as jvcoder

    jcfg = JConfig.tiny("vcoder_ds_llava")
    assert jcfg.text.num_kv_heads < jcfg.text.num_heads
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jp)
    ranks = launch.spawn(_rank_body, 4, np_params, timeout_s=300)
    return dict(jcfg=jcfg, jp=jp, np_params=np_params, ranks=ranks)


@pytest.fixture(scope="module")
def jax_mesh_tokens(setup):
    import jax

    from vcoder_tpu.parallel import make_mesh, shard_params
    from vcoder_tpu.serve.engine import ServingEngine
    from vcoder_tpu.serve.paged_engine import PagedServingEngine

    jcfg = setup["jcfg"]
    from vcoder_tpu.ops import quant as jq
    from vcoder_tpu.quant import quantize_params

    out = {}
    for case in JAX_CASES:
        kind, kw = CASES[case]
        shape = _mesh_of(case)
        mesh = make_mesh(jax.devices()[:4], data=shape[0], fsdp=shape[1], model=shape[2])
        make = (functools.partial(ServingEngine, max_len=256) if kind == "slot"
                else functools.partial(PagedServingEngine, max_len=256, page_size=8))
        params, bits = setup["jp"], kw.get("bits")
        if bits:
            params = quantize_params(params, bits=bits, destroy=False)
        jq.W8A8_MIN_TOKENS, before = W8A8_MIN_TOKENS, jq.W8A8_MIN_TOKENS
        try:
            eng = make(jcfg, shard_params(params, mesh), max_batch=4, attn_impl="xla",
                       mesh=mesh, **{k: v for k, v in kw.items() if k != "bits"})
            out[case] = _run(eng, _requests(jcfg))
        finally:
            jq.W8A8_MIN_TOKENS = before
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_engine_matches_one_device_on_every_rank(setup, case):
    want = _port_tokens(setup["np_params"], case, None)
    assert all(len(t) == 6 or 2 in t for t in want["tokens"])
    for res in setup["ranks"]:
        assert res[case]["tokens"] == want["tokens"]
    # The paged kernels ran on every rank, on its rows, as often as on one
    # device: once a layer a step; so did the W8A8 products.
    kw = CASES[case][1]
    for res in setup["ranks"]:
        assert res[case]["calls"].get("w8a8", 0) == want["calls"].get("w8a8", 0)
    assert (want["calls"].get("w8a8", 0) > 0) == ("bits" in kw)
    if CASES[case][0] == "paged":
        name = "carry_paged_attention" + ("_fused" if kw.get("fused") else (
            "_multi" if kw.get("speculative") else "") + ("_q8" if kw.get("kv_quant") else ""))
        for res in setup["ranks"]:
            assert res[case]["calls"] == want["calls"] and want["calls"][name] > 0, (
                res[case]["calls"], want["calls"])


@pytest.mark.parametrize("case", JAX_CASES)
def test_mesh_engine_matches_jax_mesh_engine(setup, jax_mesh_tokens, case):
    assert setup["ranks"][0][case]["tokens"] == jax_mesh_tokens[case]


@pytest.mark.parametrize("case", [c for c in CASES if CASES[c][0] == "paged"])
def test_pools_recycled_on_every_shard(setup, case):
    for res in setup["ranks"]:
        free = res[case]["free"]
        assert free["shards"] == _mesh_of(case)[0] * _mesh_of(case)[1]
        assert free["free"] == [free["per_shard"] - 2] * free["shards"]


def test_jax_value_errors_and_quantized_refusal(setup):
    import jax

    from vcoder_tpu.parallel import make_mesh, shard_params
    from vcoder_tpu.serve.engine import ServingEngine
    from vcoder_tpu.serve.paged_engine import PagedServingEngine

    jm = make_mesh(jax.devices()[:4], data=MESH[0], fsdp=MESH[1], model=MESH[2])
    jp = shard_params(setup["jp"], jm)
    want = {}
    for name, kw in (("prefix_cache", dict(prefix_cache=True)),
                     ("chunked_prefill", dict(chunked_prefill=16))):
        with pytest.raises(ValueError) as e:
            PagedServingEngine(setup["jcfg"], jp, max_batch=4, max_len=256, page_size=8,
                               mesh=jm, **kw)
        want[name] = str(e.value)
    with pytest.raises(ValueError) as e:
        ServingEngine(setup["jcfg"], jp, max_batch=4, max_len=256, mesh=jm,
                      lora_adapters={"a": {}})
    want["lora"] = str(e.value)
    for res in setup["ranks"]:
        errors = res["errors"]
        for name in ("prefix_cache", "chunked_prefill", "lora"):
            assert errors[name] == want[name], name
        # Quantized weights are served over the mesh (their field DTensors
        # below); multi-LoRA over them still raises JAX's ValueError.
        assert errors["lora_w8"] == want["lora"]
        assert set(errors) == {"prefix_cache", "chunked_prefill", "lora", "lora_w8"}
        assert res["quantized_fields"] == {"lm/layers/o_proj/q": "DTensor",
                                           "lm/layers/o_proj/scale": "DTensor"}
