"""The port's sharding rules, process groups and sharded flash dispatch
(``vcoder_tpu_torch/parallel/{launch,mesh,sharding,spmd}.py``, the flash
route of ``ops/attention.py::multi_head_attention`` over a mesh) against the
JAX package on the CPU.

* Every leaf's spec after ``_shrink_to_fit`` equals JAX's ``param_shardings``
  spec on the same mesh shapes (tiny configs, where the rule drops axes),
  and the DTensor placements say the same thing; so does every field of
  quantized (int8, int4), LoRA (over plain and int8 weights) and multi-LoRA
  trees, field by field.
* One group of 4 gloo ranks (``launch.spawn``, with a deadline) checks the
  rest at mesh ``(1, 2, 2)`` and ``(2, 1, 2)``: ``make_mesh`` over the group
  and its errors, ``shard_params`` (each rank's local shape, the gathered
  leaf equal to the original), ``shard_batch`` against JAX's (mirrors
  ``test_parallel.py:149``), the dispatcher's flash route on each rank's
  rows and heads against JAX's ``sharded_flash_attention`` in interpret
  mode and the plain oracle, and the plain route or unsplit heads where
  JAX returns ``None`` (mirrors ``test_sharded_attention.py``),
  the model-axis collectives with their gradients, and the wrapped trees
  above sharded field by field (each rank's local fields bit-equal to
  slices of the whole fields, cut from the specs); at ``(1, 2, 2)``
  ``load_pretrained_model(load_4bit|load_8bit, place=leaf_sharder)``,
  ``init_quantized_params(place=)`` and ``quantize_params`` over a sharded
  tree against the one-device tree, gathered.
* ``spawn`` reports a failing rank and kills a hung one at its deadline.

Rank bodies import no JAX; the JAX side runs in the test process on 4 of
its 8 virtual CPU devices. Tolerances (f32): attention 3e-5 absolute +
1e-4 relative, as JAX's own test; rules and batches exact.
"""

import contextlib
import functools
import os
import time

import numpy as np
import pytest
import torch

from vcoder_tpu_torch.parallel import launch
from vcoder_tpu_torch.parallel import mesh as tmesh
from vcoder_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)

SHAPES = [(1, 2, 2), (2, 1, 2), (2, 2, 2), (1, 4, 1), (1, 1, 4)]
B, T, H, D = 4, 128, 4, 32


def _attn_inputs():
    rng = np.random.RandomState(0)
    q, k, v = (rng.randn(B, T, H, D).astype(np.float32) for _ in range(3))
    kg, vg = (rng.randn(B, T, 2, D).astype(np.float32) for _ in range(2))
    lens = np.array([100, 128, 80, 64])
    kv_mask = np.arange(T)[None, :] < lens[:, None]
    qpos = np.broadcast_to(np.arange(T)[None, :], (B, T)).copy()
    return dict(q=q, k=k, v=v, kg=kg, vg=vg, kv_mask=kv_mask, qpos=qpos)


@functools.lru_cache(maxsize=1)
def _tiny_params_np():
    import jax

    from vcoder_tpu.config import VCoderConfig
    from vcoder_tpu.models import vcoder as jvcoder

    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), VCoderConfig.tiny("vcoder_ds_llava"))
    return jax.tree.map(np.asarray, jp)


WRAPPED = ("int8", "int4", "lora", "lora_int8", "multi_lora")


@functools.lru_cache(maxsize=1)
def _wrapped_np():
    """JAX's wrapped trees of the tiny model (numpy leaves): quantized at 8
    and 4 bits, LoRA over the plain and the int8 weights, and the
    multi-LoRA serving tree of two adapters."""
    import jax

    from vcoder_tpu.lora import add_lora, extract_adapters, stack_adapters
    from vcoder_tpu.quant import quantize_params

    jp = jax.tree.map(jax.numpy.asarray, _tiny_params_np())
    q8 = quantize_params(jp, bits=8, destroy=False)
    lora = add_lora(jp, jax.random.PRNGKey(1), rank=8)
    trees = dict(int8=q8, int4=quantize_params(jp, bits=4, destroy=False), lora=lora,
                 lora_int8=add_lora(q8, jax.random.PRNGKey(2), rank=8))
    other = extract_adapters(add_lora(jp, jax.random.PRNGKey(3), rank=4))
    trees["multi_lora"] = stack_adapters(jp, {"x": extract_adapters(lora), "y": other}, 4)[0]
    return {k: jax.tree.map(np.asarray, v) for k, v in trees.items()}


# ---------------------------------------------------------------------------
# Rules (no process group needed: a plain mesh carries the axis sizes)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_param_specs_match_jax(shape):
    import jax

    from vcoder_tpu.parallel import make_mesh as jmake
    from vcoder_tpu.parallel.sharding import _path_str, param_shardings
    from vcoder_tpu_torch.checkpoint import from_jax_params
    from vcoder_tpu_torch.config import VCoderConfig

    np_params = _tiny_params_np()
    n = int(np.prod(shape))
    jm = jmake(jax.devices()[:n], data=shape[0], fsdp=shape[1], model=shape[2])
    want = {_path_str(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(param_shardings(np_params, jm))[0]}
    tm = tmesh.make_mesh(["cpu"] * n, data=shape[0], fsdp=shape[1], model=shape[2])
    tp = from_jax_params(np_params, VCoderConfig.tiny("vcoder_ds_llava"), device="cpu")
    got = tsh.param_specs(tp, tm)
    assert got == want
    # Some axis was dropped by _shrink_to_fit somewhere at every shape.
    assert any(tsh.spec_for_path(p) != s for p, s in got.items())
    from torch.distributed.tensor import Replicate, Shard

    for path, placements in tsh.param_shardings(tp, tm).items():
        spec = got[path]
        for i, axis in enumerate(tmesh.AXES):
            dims = [j for j, names in enumerate(spec) if names and axis in
                    (names if isinstance(names, tuple) else (names,))]
            assert placements[i] == (Shard(dims[0]) if dims else Replicate()), (path, axis)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", WRAPPED)
def test_wrapped_param_specs_match_jax(kind, shape):
    import jax

    from vcoder_tpu.parallel import make_mesh as jmake
    from vcoder_tpu.parallel.sharding import _path_str, param_shardings
    from vcoder_tpu_torch.checkpoint import from_jax_params
    from vcoder_tpu_torch.config import VCoderConfig

    tree = _wrapped_np()[kind]
    n = int(np.prod(shape))
    jm = jmake(jax.devices()[:n], data=shape[0], fsdp=shape[1], model=shape[2])
    want = {_path_str(p): tuple(s.spec) for p, s in
            jax.tree_util.tree_flatten_with_path(param_shardings(tree, jm))[0]}
    tm = tmesh.make_mesh(["cpu"] * n, data=shape[0], fsdp=shape[1], model=shape[2])
    tp = from_jax_params(tree, VCoderConfig.tiny("vcoder_ds_llava"), device="cpu")
    got = tsh.param_specs(tp, tm)
    assert got == want
    fields = {"int8": "/scale", "int4": "/q", "lora": "/a", "lora_int8": "/base/q",
              "multi_lora": "/idx"}[kind]
    assert any(p.endswith(fields) for p in got)


def test_rules_are_jax_copies():
    from vcoder_tpu.parallel import sharding as jsh

    assert [(p, tuple(s)) for p, s in jsh.PARAM_RULES] == tsh.PARAM_RULES
    assert tsh.BATCH_AXES == jsh.BATCH_AXES
    import vcoder_tpu.parallel as jpar
    import vcoder_tpu_torch.parallel as tpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    for path in ("lm/layers/q_proj/q", "lm/layers/q_proj/scale", "lm/lm_head/base",
                 "mm_projector/w/0/a", "vision_tower/layers/fc1", "nothing/here"):
        assert tsh.spec_for_path(path) == tuple(jsh.spec_for_path(path))


# ---------------------------------------------------------------------------
# One group of 4 ranks
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _routes():
    """Within: the names of the attention routes taken, in order."""
    from vcoder_tpu_torch.ops import attention as ta
    from vcoder_tpu_torch.ops import flash_attention as tfa

    taken, flash, plain = [], tfa.flash_attention, ta.xla_attention

    def rec(name, fn):
        return lambda *a, **kw: (taken.append(name), fn(*a, **kw))[1]

    tfa.flash_attention, ta.xla_attention = rec("flash", flash), rec("xla", plain)
    try:
        yield taken
    finally:
        tfa.flash_attention, ta.xla_attention = flash, plain


def _slice_of(t, spec, m):
    """The slice of ``t`` a rank at ``m``'s coordinates holds under
    ``spec`` (axes on one dimension data-major), cut here from the spec."""
    idx = []
    for j, names in enumerate(tuple(spec) + (None,) * (t.ndim - len(spec))):
        names = () if names is None else names if isinstance(names, tuple) else (names,)
        parts, at = 1, 0
        for nm in names:
            at = at * m.shape[nm] + m.local_rank(nm)
            parts *= m.shape[nm]
        n = t.shape[j] // parts
        idx.append(slice(at * n, (at + 1) * n))
    return t[tuple(idx)]


def _quantized_loads(m, ckpt):
    """Each quantized load or draw placed leaf by leaf over ``m``, against
    the one-device tree: every field a DTensor, gathered equal."""
    from vcoder_tpu_torch.builder import load_pretrained_model
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.models.vcoder import init_vcoder_params
    from vcoder_tpu_torch.quant import init_quantized_params, quantize_params
    from vcoder_tpu_torch.tree import named_leaves

    def same(tree, ref):
        got, want = dict(named_leaves(tree)), dict(named_leaves(ref))
        return sorted(got) == sorted(want) and all(
            type(t).__name__ == "DTensor" and torch.equal(t.full_tensor(), want[p])
            for p, t in got.items())

    out = {}
    for flag in ("load_4bit", "load_8bit"):
        kw = dict(device="cpu", dtype=torch.float32, **{flag: True})
        placed = load_pretrained_model(ckpt, place=tsh.leaf_sharder(m), **kw)[1].params
        out[flag] = same(placed, load_pretrained_model(ckpt, **kw)[1].params)
        out[flag + "_wrapped"] = type(placed["lm"]["layers"]["down_proj"]).__name__
    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    kw = dict(seed=3, dtype=torch.float32, device="cpu")
    out["init_quantized"] = same(init_quantized_params(cfg, 4, place=tsh.leaf_sharder(m), **kw),
                                 init_quantized_params(cfg, 4, **kw))
    # A sharded tree quantized in place: each leaf gathered a layer at a time.
    sharded = tsh.shard_params(init_vcoder_params(cfg, **kw), m)
    out["quantize_sharded"] = same(
        quantize_params(sharded, bits=8, destroy=False, place=tsh.leaf_sharder(m)),
        quantize_params(init_vcoder_params(cfg, **kw), bits=8))
    return out


def _group_body(rank, world, np_params, att, wrapped_np, ckpt):
    """Everything that needs the process group, at two mesh shapes."""
    from torch.distributed.tensor import DTensor

    from vcoder_tpu_torch.checkpoint import from_jax_params
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.lora import LoraWeight, merge_lora
    from vcoder_tpu_torch.ops.attention import multi_head_attention
    from vcoder_tpu_torch.ops.quant import QuantizedTensor
    from vcoder_tpu_torch.parallel import spmd
    from vcoder_tpu_torch.tree import named_leaves

    torch.set_num_threads(1)
    out = {"errors": {}}
    default = tmesh.make_mesh()
    out["default_shape"] = default.shape
    out["device"] = str(default.device)
    for kw in ({"data": 3}, {"data": 2, "fsdp": 1, "model": 1}, {"data": 2, "fsdp": 2, "model": 2}):
        try:
            tmesh.make_mesh(**kw)
            out["errors"][str(kw)] = None
        except ValueError as e:
            out["errors"][str(kw)] = str(e)
    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    for shape in ((1, 2, 2), (2, 1, 2)):
        m = tmesh.make_mesh(data=shape[0], fsdp=shape[1], model=shape[2])
        res = out[shape] = {"row_index": m.row_index, "model_rank": m.local_rank("model")}
        params = from_jax_params(np_params, cfg, device="cpu")
        full = {p: t.clone() for p, t in named_leaves(params)}
        tsh.shard_params(params, m)
        res["local_shapes"] = {p: tuple(t.to_local().shape) for p, t in named_leaves(params)}
        res["gathered_equal"] = all(torch.equal(t.full_tensor(), full[p])
                                    for p, t in named_leaves(params))
        batch = {"x": torch.arange(4 * 8, dtype=torch.float32).reshape(4, 8),
                 "s": torch.tensor(3)}
        sb = tsh.shard_batch(batch, m)
        res["batch_local"] = sb["x"].to_local().numpy()
        res["batch_full_equal"] = torch.equal(sb["x"].full_tensor(), batch["x"])
        res["batch_placements"] = [str(p) for p in sb["x"].placements]
        try:
            tsh.shard_batch({"x": torch.zeros(3, 2)}, m)
        except ValueError as e:
            res["batch_error"] = str(e)
        # The flash route the model takes over the mesh: this rank's rows
        # (under local_rows) and heads through the dispatcher.
        q, k, v, kg, vg = (torch.from_numpy(att[n]) for n in ("q", "k", "v", "kg", "vg"))
        qpos, mask = torch.from_numpy(att["qpos"]), torch.from_numpy(att["kv_mask"])
        with tmesh.use_mesh(m):
            rs, mr, nm = spmd.row_slice(B), m.local_rank("model"), m.shape["model"]

            def mine(x):
                n = x.shape[2] // nm
                return x[rs, :, mr * n:(mr + 1) * n]

            kw = dict(causal=True, q_positions=qpos[rs], kv_mask=mask[rs])
            with spmd.local_rows(), _routes() as routes:
                res["flash"] = multi_head_attention(mine(q), mine(k), mine(v), **kw).numpy()
                res["flash_gqa"] = multi_head_attention(mine(q), mine(kg), mine(vg), **kw).numpy()
            res["flash_routes"] = routes
            # Every row on every rank, a batch the row shards do not divide:
            # the plain route (JAX's sharded_flash_attention returns None).
            with _routes() as routes:
                res["odd_batch"] = multi_head_attention(
                    q[:3], k[:3], v[:3], causal=True, q_positions=qpos[:3],
                    kv_mask=mask[:3]).numpy()
            res["odd_batch_routes"] = routes
            # KV heads the model axis does not divide: the model keeps every
            # head on every rank (JAX's None on indivisible KV heads).
            res["kv_heads"] = (spmd.tp_blocks((6, 3), 1)["attn"], spmd.local_heads(6, (6, 3)),
                               spmd.local_heads(3, (6, 3)), spmd.local_heads(4, (4, 2)))
        # Collectives over model, and their gradients.
        with tmesh.use_mesh(m):
            x = torch.full((2, 3), float(m.local_rank("model") + 1), requires_grad=True)
            g = spmd.gather_from_model(x, -1)
            r = spmd.reduce_from_model(x * 1.0)
            (g.sum() * 2 + r.sum()).backward()
            res["gathered"] = g.detach().numpy()
            res["reduced"] = r.detach().numpy()
            res["grad"] = x.grad.numpy()
            y = torch.ones(2, 3, requires_grad=True)
            spmd.copy_to_model(y).sum().backward()
            res["copy_grad"] = y.grad.numpy()
            res["rows"] = spmd.gather_rows(torch.tensor([m.row_index])).tolist()
        # Quantized and LoRA-wrapped trees: every field a DTensor whose
        # local part is the slice its spec gives, and whole when gathered.
        res["wrapped"] = {}
        for kind, tree in wrapped_np.items():
            tp = from_jax_params(tree, cfg, device="cpu")
            lora_leaves = [w for _, w in tsh._leaves(tp) if isinstance(w, LoraWeight)]
            for w in lora_leaves:  # B non-zero, so a merge folds something
                w.b.copy_(torch.linspace(-0.1, 0.1, w.b.numel()).reshape(w.b.shape))
            merged_one = dict(named_leaves(merge_lora(tp))) if lora_leaves else None
            whole = {p: t.clone() for p, t in named_leaves(tp)}
            specs = tsh.param_specs(tp, m)
            tsh.shard_params(tp, m)
            sharded = dict(named_leaves(tp))
            res["wrapped"][kind] = dict(
                types=sorted({type(v).__name__ for _, v in tsh._leaves(tp)}),
                all_dtensors=all(isinstance(t, DTensor) for t in sharded.values()),
                slices_equal=all(torch.equal(t.to_local(), _slice_of(whole[p], specs[p], m))
                                 for p, t in sharded.items()),
                gathered_equal=all(torch.equal(t.full_tensor(), whole[p])
                                   for p, t in sharded.items()),
                some_split=any(t.to_local().numel() < t.numel() for p, t in sharded.items()
                               if p.rsplit("/", 1)[-1] in ("q", "scale", "a", "b")))
            if lora_leaves:
                # Merged over the mesh: each leaf placed as its stored base,
                # gathered equal to one device's merge.
                stored = {path: (w.base.q if isinstance(w.base, QuantizedTensor) else w.base)
                          for path, w in tsh._leaves(tp) if isinstance(w, LoraWeight)}
                merged = dict(named_leaves(merge_lora(tp)))
                res["wrapped"][kind].update(
                    merged_placed=all(isinstance(merged[p], DTensor)
                                      and merged[p].placements == t.placements
                                      for p, t in stored.items()),
                    merged_equal=all(torch.equal(merged[p].full_tensor(), merged_one[p])
                                     for p in stored),
                    merged_moved=any(not torch.equal(merged_one[p], whole[f"{p}/base"])
                                     for p in stored if f"{p}/base" in whole))
        try:
            tsh.shard_params({"lm": {"lm_head": object()}}, m)
        except TypeError as e:
            res["refused_object"] = str(e)
        # A wrapper made on the fly, placed by its weight's rule.
        qt = tsh.shard_leaf("lm/lm_head", QuantizedTensor(
            torch.zeros(8, 4, dtype=torch.int8), torch.ones(1, 4), 4), m)
        lw = tsh.shard_leaf("lm/layers/o_proj", LoraWeight(
            torch.zeros(2, 4, 4), torch.zeros(2, 4, 2), torch.zeros(2, 2, 4), 1.0), m)
        res["on_the_fly"] = (tuple(qt.q.placements), tuple(lw.a.placements), qt.bits, lw.scale)
        if shape == (1, 2, 2):
            res["quantized_loads"] = _quantized_loads(m, ckpt)
        assert isinstance(params["lm"]["norm"], DTensor)
        # Seeded leaf by leaf (each leaf sharded as it is drawn) against the
        # whole tree sharded after: the same shards and placements.
        from vcoder_tpu_torch.models.vcoder import init_vcoder_params

        kw = dict(seed=3, dtype=torch.float32, device="cpu")
        leafwise = dict(named_leaves(init_vcoder_params(cfg, place=tsh.leaf_sharder(m), **kw)))
        whole = dict(named_leaves(tsh.shard_params(init_vcoder_params(cfg, **kw), m)))
        res["leafwise"] = (sorted(leafwise) == sorted(whole) and all(
            isinstance(t, DTensor) and t.placements == whole[p].placements
            and torch.equal(t.to_local(), whole[p].to_local()) for p, t in leafwise.items()))
        # No shard is a view that keeps its whole leaf alive.
        res["own_storage"] = all(
            t.to_local().untyped_storage().nbytes() == t.to_local().numel() * t.element_size()
            for t in leafwise.values())
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    from vcoder_tpu_torch.checkpoint import from_jax_params, save_pretrained
    from vcoder_tpu_torch.config import VCoderConfig

    np_params = _tiny_params_np()
    att = _attn_inputs()
    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "vcoder_ds_llava-tiny")
    save_pretrained(ckpt, from_jax_params(np_params, cfg, device="cpu"), cfg)
    t0 = time.time()
    res = launch.spawn(_group_body, 4, np_params, att, _wrapped_np(), ckpt, timeout_s=240)
    return dict(res=res, np_params=np_params, att=att, seconds=time.time() - t0)


def test_make_mesh_over_the_group(group):
    for r, out in enumerate(group["res"]):
        assert out["default_shape"] == {"data": 1, "fsdp": 4, "model": 1}  # JAX's default
        assert out["device"] == "cpu"
        assert out["errors"]["{'data': 3}"] and "not divisible" in out["errors"]["{'data': 3}"]
        assert "do not cover" in out["errors"]["{'data': 2, 'fsdp': 1, 'model': 1}"]
        assert "needs 8 devices" in out["errors"]["{'data': 2, 'fsdp': 2, 'model': 2}"]
    coords = {(out[(2, 1, 2)]["row_index"], out[(2, 1, 2)]["model_rank"])
              for out in group["res"]}
    assert coords == {(0, 0), (0, 1), (1, 0), (1, 1)}


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2)], ids=["1x2x2", "2x1x2"])
def test_shard_params_keeps_each_ranks_slice(group, shape):
    from vcoder_tpu_torch.checkpoint import from_jax_params
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.tree import named_leaves

    tp = from_jax_params(group["np_params"], VCoderConfig.tiny("vcoder_ds_llava"), device="cpu")
    m = tmesh.make_mesh(["cpu"] * 4, data=shape[0], fsdp=shape[1], model=shape[2])
    specs = tsh.param_specs(tp, m)
    for out in group["res"]:
        res = out[shape]
        assert res["gathered_equal"]
        for path, t in named_leaves(tp):
            want = list(t.shape)
            for j, names in enumerate(specs[path]):
                for nm in (names if isinstance(names, tuple) else (names,)) if names else ():
                    want[j] //= m.shape[nm]
            assert res["local_shapes"][path] == tuple(want), path
        # Quantized and LoRA-wrapped leaves are placed field by field.
        for kind in WRAPPED:
            w = res["wrapped"][kind]
            assert w["all_dtensors"] and w["slices_equal"] and w["gathered_equal"], kind
            assert w["some_split"], kind
        assert res["wrapped"]["lora_int8"]["types"] == ["DTensor", "LoraWeight", "QuantizedTensor"]
        assert res["wrapped"]["multi_lora"]["types"] == ["DTensor", "MultiLoraWeight"]
        assert "cannot be placed on a mesh" in res["refused_object"]
        q_pl, a_pl, bits, scale = res["on_the_fly"]
        assert (bits, scale) == (4, 1.0)
        # lm_head (fsdp, model) over packed [4, 4]; o_proj's a (None, model, fsdp).
        assert [str(p) for p in q_pl] == ["R", "S(0)", "S(1)"]
        assert [str(p) for p in a_pl][2] == "S(1)"
    if shape == (1, 2, 2):
        for out in group["res"]:
            loads = out[shape]["quantized_loads"]
            assert loads == {"load_4bit": True, "load_8bit": True, "init_quantized": True,
                             "quantize_sharded": True, "load_4bit_wrapped": "QuantizedTensor",
                             "load_8bit_wrapped": "QuantizedTensor"}


@pytest.mark.parametrize("kind", ["lora", "lora_int8"])
@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2)], ids=["1x2x2", "2x1x2"])
def test_merge_lora_over_the_mesh_equals_one_device(group, shape, kind):
    """``merge_lora`` of a sharded LoRA tree (B non-zero; a plain and an
    int8 base): each merged leaf is placed as its stored base was, and
    gathered it equals one device's merge bit for bit."""
    for out in group["res"]:
        w = out[shape]["wrapped"][kind]
        assert w["merged_placed"] and w["merged_equal"], (shape, kind)
        if kind == "lora":
            assert w["merged_moved"]


@pytest.mark.parametrize("shape", [(1, 2, 2), (2, 1, 2)], ids=["1x2x2", "2x1x2"])
def test_shard_batch_matches_jax(group, shape):
    import jax

    from vcoder_tpu.parallel import make_mesh as jmake
    from vcoder_tpu.parallel.sharding import shard_batch

    jm = jmake(jax.devices()[:4], data=shape[0], fsdp=shape[1], model=shape[2])
    x = np.arange(4 * 8, dtype=np.float32).reshape(4, 8)
    jx = shard_batch({"x": x}, jm)["x"]
    assert tuple(jx.sharding.spec)[0] == tsh.BATCH_AXES
    # JAX's shard on each device of the mesh, by (data, fsdp) coordinate.
    want = {}
    for dev, idx in jx.sharding.devices_indices_map(x.shape).items():
        want[tuple(int(i) for i in np.argwhere(jm.devices == dev)[0][:2])] = x[idx]
    for out in group["res"]:
        res = out[shape]
        row = res["row_index"]
        coord = (row // shape[1], row % shape[1])
        np.testing.assert_array_equal(res["batch_local"], want[coord])
        assert res["batch_full_equal"]
        assert res["batch_placements"][:2] == ["S(0)", "S(0)"]
        assert "row shards" in res["batch_error"]


@pytest.mark.parametrize("gqa", [False, True], ids=["mha", "gqa"])
def test_sharded_flash_matches_jax_and_oracle(group, gqa):
    import jax
    import jax.numpy as jnp

    from vcoder_tpu.ops.attention import sharded_flash_attention as jflash
    from vcoder_tpu.ops.attention import xla_attention
    from vcoder_tpu.parallel import make_mesh as jmake

    att = group["att"]
    k, v = (att["kg"], att["vg"]) if gqa else (att["k"], att["v"])
    jm = jmake(jax.devices()[:4], data=1, fsdp=2, model=2)
    args = (jnp.asarray(att["q"]), jnp.asarray(k), jnp.asarray(v))
    kw = dict(causal=True, q_positions=jnp.asarray(att["qpos"]),
              kv_mask=jnp.asarray(att["kv_mask"]))
    want = np.asarray(jflash(*args, jm, interpret=True, **kw))
    oracle = np.asarray(xla_attention(*args, **kw))
    per = B // 2
    for out in group["res"]:
        for shape in ((1, 2, 2), (2, 1, 2)):
            res = out[shape]
            got = res["flash_gqa" if gqa else "flash"]
            ri, mr = res["row_index"], res["model_rank"]
            mine = (slice(ri * per, (ri + 1) * per), slice(None), slice(mr * 2, mr * 2 + 2))
            assert got.shape == (per, T, H // 2, D)
            np.testing.assert_allclose(got, want[mine], atol=3e-5, rtol=1e-4)
            np.testing.assert_allclose(got, oracle[mine], atol=3e-5, rtol=1e-4)
            assert res["flash_routes"] == ["flash", "flash"]


def test_sharded_flash_declines_indivisible_shapes(group):
    import jax
    import jax.numpy as jnp

    from vcoder_tpu.ops.attention import sharded_flash_attention as jflash
    from vcoder_tpu.ops.attention import xla_attention
    from vcoder_tpu.parallel import make_mesh as jmake

    jm = jmake(jax.devices()[:4], data=1, fsdp=2, model=2)
    q = np.zeros((4, 128, 6, 32), np.float32)
    assert jflash(q, q[:, :, :3], q[:, :, :3], jm, causal=False) is None
    assert jflash(q[:3], q[:3], q[:3], jm, causal=False) is None
    att = group["att"]
    oracle = np.asarray(xla_attention(
        *(jnp.asarray(att[n][:3]) for n in ("q", "k", "v")), causal=True,
        q_positions=jnp.asarray(att["qpos"][:3]), kv_mask=jnp.asarray(att["kv_mask"][:3])))
    for out in group["res"]:
        for shape in ((1, 2, 2), (2, 1, 2)):
            res = out[shape]
            assert res["odd_batch_routes"] == ["xla"]
            np.testing.assert_allclose(res["odd_batch"], oracle, atol=3e-5, rtol=1e-4)
            # model = 2 does not divide 3 KV heads: all 6 + 3 stay on the rank;
            # it divides 4 + 2, which split.
            assert res["kv_heads"] == (False, 6, 3, 2)
    assert tmesh.make_mesh(["cpu"] * 4).distributed is False
    from vcoder_tpu_torch.parallel import spmd

    with tmesh.use_mesh(tmesh.make_mesh(["cpu"] * 4)):
        assert spmd.mesh() is None  # a plain mesh takes the one-device route


def test_leaf_by_leaf_seeding_matches_shard_params(group):
    assert tsh.leaf_sharder(tmesh.make_mesh(["cpu"] * 4)) is None  # no group: no sharding
    for out in group["res"]:
        for shape in ((1, 2, 2), (2, 1, 2)):
            assert out[shape]["leafwise"] and out[shape]["own_storage"]


def test_model_axis_collectives_and_gradients(group):
    for out in group["res"]:
        res = out[(1, 2, 2)]
        mr = res["model_rank"]
        np.testing.assert_array_equal(res["gathered"], np.concatenate(
            [np.full((2, 3), 1.0), np.full((2, 3), 2.0)], axis=1))
        np.testing.assert_array_equal(res["reduced"], np.full((2, 3), 3.0))
        # d/dx of (2 * sum(gather) + sum(reduce)): 2 from this rank's slice,
        # 1 through the reduce (identity backward).
        np.testing.assert_array_equal(res["grad"], np.full((2, 3), 3.0))
        np.testing.assert_array_equal(res["copy_grad"], np.full((2, 3), 2.0))
        assert res["rows"] == [0, 1] and mr in (0, 1)


# ---------------------------------------------------------------------------
# spawn's failure handling
# ---------------------------------------------------------------------------


def _fails_on_rank_1(rank, world):
    if rank == 1:
        raise RuntimeError("rank one gives up")
    import torch.distributed as dist

    dist.barrier()  # rank 0 waits here until it is killed
    return rank


def _hangs(rank, world, marker):
    with open(os.path.join(marker, f"started-{rank}"), "w") as f:
        f.write(str(os.getpid()))
    time.sleep(600)


def test_spawn_reports_a_failed_rank_and_kills_the_rest():
    t0 = time.time()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of 2 failed.*rank one gives up"):
        launch.spawn(_fails_on_rank_1, 2, timeout_s=60)
    assert time.time() - t0 < 50


def test_spawn_kills_hung_ranks_at_the_deadline(tmp_path):
    t0 = time.time()
    with pytest.raises(TimeoutError, match="still running"):
        launch.spawn(_hangs, 2, str(tmp_path), timeout_s=12)
    assert time.time() - t0 < 40
    for name in os.listdir(tmp_path):  # every rank that got to its body is gone
        pid = int((tmp_path / name).read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_plain_multi_device_mesh_names_the_launchers():
    with pytest.raises(NotImplementedError, match="torch.distributed.run.*launch.spawn"):
        tmesh.make_mesh(["cpu"] * 2).device
    assert not launch.in_torchrun()
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        launch.init_distributed("cpu")


# ---------------------------------------------------------------------------
# Rank bodies the one-device tests of other files run under a spawned group
# (here: this module imports no JAX at its top, so a rank imports none)
# ---------------------------------------------------------------------------


def mesh_rank(rank, world, kw):
    """``make_mesh(**kw)`` over the group: (shape, this rank's device)."""
    m = tmesh.make_mesh(**kw)
    return m.shape, str(m.device), m.distributed


def tiny_params(seed: int = 3):
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.models.vcoder import init_vcoder_params

    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    return cfg, init_vcoder_params(cfg, seed=seed, device="cpu", dtype=torch.float32)


def engine_rank(rank, world, kind, shape, requests, kw):
    """A slot or paged engine on the tiny DS model over the group's mesh:
    each request's tokens."""
    from vcoder_tpu_torch.serve.engine import ServingEngine
    from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine

    torch.set_num_threads(1)
    cfg, params = tiny_params()
    mesh = tmesh.make_mesh(data=shape[0], fsdp=shape[1], model=shape[2])
    make = ServingEngine if kind == "slot" else functools.partial(PagedServingEngine,
                                                                  page_size=8)
    eng = make(cfg, params, max_len=256, attn_impl="xla", device="cpu", mesh=mesh, **kw)
    rids = [eng.add_request(ids, images=px, segs=px, depths=px, max_new_tokens=n)
            for ids, px, n in requests]
    res = eng.run()
    return [res[r] for r in rids]


def host_shardings_rank(rank, world):
    """``host_shardings`` of a DTensor state over the group: each rank's
    placements and the host shard it keeps."""
    from torch.distributed.tensor import distribute_tensor

    m = tmesh.make_mesh(data=1, fsdp=2, model=1)
    state = {"mu/x": distribute_tensor(torch.arange(8.0), m.device_mesh,
                                       tsh.placements_of(("fsdp",), m), src_data_rank=None),
             "count": torch.zeros((), dtype=torch.int32)}
    sh = tsh.host_shardings(state, m)
    host = tsh.offload_to_host(state, m)
    return ({k: (str(p.device), p.memory_kind) for k, p in sh.items()},
            host["mu/x"].tolist(), host["mu/x"].device.type)


def trainer_rank(rank, world, offload, out):
    """Two ``Trainer`` steps of the tiny DS model over the group at (1, 2, 1),
    checkpointing into ``out`` (shared by the ranks) after each, then a
    second trainer resuming from it: the losses and the trained leaves
    gathered."""
    from torch.distributed.tensor import DTensor

    from vcoder_tpu_torch.train import step as tstep
    from vcoder_tpu_torch.train.trainer import TrainArgs, Trainer

    torch.set_num_threads(1)
    import chip_smoke

    cfg, params = tiny_params()
    samples = chip_smoke.DSSamples(8, cfg.vision.image_size)
    m = tmesh.make_mesh(data=1, fsdp=2, model=1)
    # A checkpoint after every step: rank 0 writes, resident or host state.
    args = TrainArgs(output_dir=out, per_device_train_batch_size=1, dataloader_workers=0,
                     learning_rate=1e-2, offload_opt_state=offload, save_steps=1)
    tr = Trainer(cfg, params, samples, args, mesh=m, device="cpu")
    hist = tr.train(max_steps=2)
    again = Trainer(cfg, tiny_params()[1], samples, args, mesh=m, device="cpu")
    assert again.maybe_resume() and again.step == 2
    for k, t in again.opt_state.items():
        assert torch.equal(tstep._local(t), tstep._local(tr.opt_state[k])), k
    leaves = tstep.trainable_leaves(tr.params, args.stage)
    return ([h["loss"] for h in hist],
            {p: (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()
             for p, t in leaves.items()})
