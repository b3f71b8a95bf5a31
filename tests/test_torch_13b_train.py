"""VCoder-DS-13B training's geometry on the CPU: the port against the JAX
package at 13B's head layout (H = KH = 40 heads of 8, hidden 320,
intermediate 864, 2 layers, the tiny tower; f32, JAX's init perturbed by
seeded numpy noise, carried across by ``from_jax_params``).

* The ``vcoder_ds`` stage: three steps of the port's step (the flash
  Function, whose CPU backward is the plain version of the K6 kernels,
  under ``remat="dots"``) against JAX's step: losses and grad norms within
  1e-5 relative (tests/test_torch_train_step.py's tolerance), the frozen
  leaves bit-equal, the trained ones within 1e-4 relative + 5% of the
  learning rate absolute. Adam divides each gradient by its own magnitude
  plus eps = 1e-8, so an element whose gradient lies near 1e-8 moves by an
  amount its gradient's last bits decide: at 40 heads a few elements a
  leaf (2 of 102,400 in the seg projector's second weight after three
  steps) land up to 2.3% of one step's lr apart, every other within 1e-4.
* The ``it_lora`` stage with ``gradient_accumulation_steps=4`` from JAX's
  adapters (B = 0): twelve micro-batches (three updates) against JAX's
  accumulated step, losses and grad norms as above, every leaf after the
  three updates as above. ``a``'s gradient is exactly 0 through the first
  eight micro-batches (the first update runs at lr 0, so b is still 0
  through the second) while every ``b``'s is not, so the third update is
  ``a``'s first Adam step: sign(g) x the step's lr, but for gradients near
  eps, which it leaves anywhere in between. There each ``a`` leaf is held
  to JAX's within the same tolerance with at most ``EPS_MISMATCHES``
  elements outside it (measured: 0-2 of 5,120-13,824 a leaf, the worst
  47% of lr apart in ``gate_proj/a``; a wrong sign, scale or bias
  correction moves thousands).
* The ``vcoder_it --lora-enable`` driver in both packages from a
  llava-typed directory written by ``chip_smoke.write_llava_dir``: the same
  leaf names and shapes in ``adapters.safetensors`` and ``final/``, the
  same first loss (2e-5 relative; B starts at zero), and each package's
  ``final/`` loading in the other.
* ``lora.merge_lora`` on one device folds a stacked leaf one layer at a
  time: bit-equal to the whole-stack fold over plain, int8 and int4 bases,
  ``_fold`` never handed more than one layer, and equal to JAX's merge at
  this layout within 1e-6 (tests/test_torch_lora.py's tolerance).
"""

import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vcoder_tpu import lora as jlora
from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.constants import DEPTH_TOKEN_INDEX, IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.parallel.sharding import _path_str
from vcoder_tpu.train import step as jstep
from vcoder_tpu.train.collator import collate_batch as j_collate
from vcoder_tpu_torch import lora as tlora
from vcoder_tpu_torch.checkpoint import from_jax_params, read_safetensors
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.ops import quant as tq
from vcoder_tpu_torch.train import step as tstep
from vcoder_tpu_torch.train.collator import collate_batch as t_collate
from vcoder_tpu_torch.tree import named_leaves

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _narrow(cfg_cls, model_type="vcoder_ds_llava"):
    """13B's head layout at a width the CPU runs in milliseconds."""
    base = cfg_cls.tiny(model_type)
    return dataclasses.replace(base, text=dataclasses.replace(
        base.text, hidden_size=320, intermediate_size=864, num_heads=40, num_kv_heads=40))


def _perturbed(jp, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), jp)


def _samples(cfg, n, seed, it=False):
    """n right-padded samples: DS (depth, seg, image) or IT (image, seg)."""
    rng = np.random.RandomState(seed)
    S = cfg.vision.image_size
    mods = ("image", "seg") if it else ("image", "seg", "depth")
    sentinels = [IMAGE_TOKEN_INDEX, SEG_TOKEN_INDEX] if it else [
        IMAGE_TOKEN_INDEX, DEPTH_TOKEN_INDEX, SEG_TOKEN_INDEX]
    out = []
    for i in range(n):
        n_q, n_a = ((3, 6), (2, 3), (4, 5), (1, 7))[i % 4]
        prompt = [1] + list(rng.randint(3, 200, n_q)) + sentinels + [17]
        answer = list(rng.randint(3, 200, n_a)) + [2]
        out.append(dict(input_ids=prompt + answer, labels=[-100] * len(prompt) + answer,
                        **{m: rng.randn(S, S, 3).astype(np.float32) for m in mods}))
    return out


def _batches(jcfg, samples, it=False):
    kw = dict(num_patches=jcfg.vision.num_patches, ds_mode=not it, it_mode=it, use_seg=True,
              use_depth=not it, image_size=jcfg.vision.image_size, pad_multiple=16)
    return j_collate(samples, as_jnp=True, **kw), t_collate(samples, device="cpu", **kw)


def _jax_flat(tree):
    return {_path_str(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _steps(stage, jcfg, tcfg, np_params, batches, n, lr, accum=1, leaves_at=None):
    """n steps of each package's step over ``batches`` in turn: the losses
    and grad norms of both, the port's per-leaf norms and its leaves after
    ``leaves_at`` steps (``got["at"]``), and each package's leaves after n
    (the trained ones' paths in ``got["trained"]``)."""
    jopt = jstep.make_optimizer(lr, 10, accum_steps=accum)
    jp = jax.tree.map(jnp.asarray, np_params)
    jstate = jstep.init_opt_state(jp, jopt, stage)
    jfn = jstep.make_train_step(jcfg, jopt, stage=stage, attn_impl="xla", remat=False)
    topt = tstep.make_optimizer(lr, 10, accum_steps=accum)
    tp = from_jax_params(np_params, tcfg, device="cpu")
    tstate = tstep.init_opt_state(tp, topt, stage)
    tfn = tstep.make_train_step(tcfg, topt, stage=stage, attn_impl="auto", remat="dots")
    got = dict(j=[], t=[], norms=[], lr=lr, trained=set(tstep.trainable_leaves(tp, stage)))
    port = lambda: {p: t.detach().numpy().copy() for p, t in named_leaves(tp)}  # noqa: E731
    for i in range(n):
        jb, tb = batches[i % len(batches)]
        jp, jstate, jm = jfn(jp, jstate, jb)
        tp, tstate, tm = tfn(tp, tstate, tb)
        got["j"].append((float(jm["loss"]), float(jm["grad_norm"])))
        got["t"].append((float(tm["loss"]), float(tm["grad_norm"])))
        got["norms"].append({k: float(v) for k, v in tm["leaf_grad_norms"].items()})
        if i + 1 == leaves_at:
            got["at"] = port()
    return got, _jax_flat(jp), port()


# Elements of an ``a`` leaf allowed outside the tolerance after its first
# Adam step: those whose gradient lies near eps (module docstring).
EPS_MISMATCHES = 4


def _assert_steps_match(got, jleaves, tleaves, first_step=()):
    """Losses and grad norms within 1e-5; frozen leaves bit-equal; trained
    ones within 1e-4 relative + 5% of lr, but for at most
    ``EPS_MISMATCHES`` elements of each leaf in ``first_step``."""
    np.testing.assert_allclose(np.asarray(got["t"]), np.asarray(got["j"]), rtol=1e-5)
    assert set(tleaves) == set(jleaves)
    tol = dict(atol=0.05 * got["lr"], rtol=1e-4)
    for path, t in tleaves.items():
        if path in first_step:
            off = int((~np.isclose(t, jleaves[path], **tol)).sum())
            assert off <= EPS_MISMATCHES, (path, off, t.size)
        elif path in got["trained"]:
            np.testing.assert_allclose(t, jleaves[path], err_msg=path, **tol)
        else:
            np.testing.assert_array_equal(t, jleaves[path], err_msg=path)


def test_vcoder_ds_steps_match_jax_at_the_13b_layout():
    jcfg, tcfg = _narrow(JConfig), _narrow(TConfig)
    assert (tcfg.text.num_heads, tcfg.text.num_kv_heads, tcfg.text.head_dim) == (40, 40, 8)
    np_params = _perturbed(jvcoder.init_vcoder_params(jax.random.PRNGKey(13), jcfg), 13)
    batch = _batches(jcfg, _samples(jcfg, 2, 0))
    got, jleaves, tleaves = _steps("vcoder_ds", jcfg, tcfg, np_params, [batch], 3, 1e-3)
    _assert_steps_match(got, jleaves, tleaves)
    for n in got["norms"]:
        assert n["vcoder_lm_emb"] > 0 and n["seg_projector/w/0"] > 0
        assert n["depth_projector/w/0"] == 0  # depth goes through the seg projector
    assert not np.array_equal(tleaves["seg_projector/w/0"], np_params["seg_projector"]["w"][0])


def test_it_lora_accumulated_steps_match_jax_at_the_13b_layout():
    jcfg, tcfg = _narrow(JConfig, "vcoder_it_llava"), _narrow(TConfig, "vcoder_it_llava")
    jp = jax.tree.map(jnp.asarray, _perturbed(jvcoder.init_vcoder_params(
        jax.random.PRNGKey(7), jcfg), 7))
    np_lora = jax.tree.map(np.asarray, jlora.add_lora(jp, jax.random.PRNGKey(5), rank=8,
                                                      alpha=16.0))
    batches = [_batches(jcfg, _samples(jcfg, 2, s, it=True), it=True) for s in (1, 2)]
    accum = 4
    got, jleaves, tleaves = _steps("it_lora", jcfg, tcfg, np_lora, batches, 3 * accum, 1e-2,
                                   accum=accum, leaves_at=2 * accum)
    a_keys = [k for k in got["norms"][0] if k.endswith("/a")]
    b_keys = [k for k in got["norms"][0] if k.endswith("/b")]
    assert len(a_keys) == len(b_keys) == 7
    _assert_steps_match(got, jleaves, tleaves, first_step=a_keys)
    for i, n in enumerate(got["norms"]):
        assert all(n[k] > 0 for k in b_keys), i
        assert all((n[k] == 0) == (i < 2 * accum) for k in a_keys), (i, [n[k] for k in a_keys])
    start = {p: np.asarray(x) for p, x in _jax_flat(np_lora).items()}
    for path in a_keys:  # after two updates a is where it started, after the third not
        np.testing.assert_array_equal(got["at"][path], start[path], err_msg=path)
        assert not np.array_equal(tleaves[path], start[path]), path
    for path in b_keys:
        assert not np.array_equal(got["at"][path], start[path]), path
    assert np.array_equal(tleaves["lm/layers/q_proj/base"], start["lm/layers/q_proj/base"])


@pytest.fixture
def f32(monkeypatch):
    """Both packages' drivers load their base checkpoint in f32."""
    import vcoder_tpu.builder as jb
    import vcoder_tpu_torch.builder as tb

    monkeypatch.setattr(jb, "load_pretrained_model",
                        functools.partial(jb.load_pretrained_model, dtype=jnp.float32))
    monkeypatch.setattr(tb, "load_pretrained_model",
                        functools.partial(tb.load_pretrained_model, dtype=torch.float32))


def _header(path):
    return {k: tuple(t.shape) for k, t in read_safetensors(path).items()}


def test_it_lora_driver_matches_jax_from_a_llava_directory(tmp_path, f32):
    pytest.importorskip("PIL")
    import vcoder_tpu.builder as jb
    import vcoder_tpu_torch.builder as tb
    from tests.test_torch_train_drivers import FLAGS, TEXT, _losses, _run_jax, _run_torch
    from tests.test_train_pipeline import _make_cost_tree
    from vcoder_tpu.checkpoint import save_pretrained as jsave
    from vcoder_tpu.simple_tokenizer import SimpleTokenizer as JTokenizer

    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    root = str(tmp_path / "cost")
    os.makedirs(root)
    _make_cost_tree(root)
    jcfg = _narrow(JConfig)
    ds_dir, base = str(tmp_path / "vcoder_ds_llava-narrow"), str(tmp_path / "llava-narrow")
    jsave(ds_dir, jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg), jcfg)
    JTokenizer.build_from_texts([TEXT]).save_pretrained(ds_dir)
    chip_smoke.write_llava_dir(base, ds_dir)
    with open(os.path.join(base, "config.json")) as f:
        assert json.load(f)["model_type"] == "llava"
    argv = ["--model-path", base, "--seg-data-path", root, "--image-folder", root] + FLAGS + [
        "--lora-enable", "--lora-r", "8", "--lora-alpha", "16"]
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    _run_jax("it", argv + ["--output-dir", jout])
    trainer = _run_torch("it", argv + ["--output-dir", tout])
    assert trainer.args.stage == "it_lora" and trainer.opt_state == {}  # released for the merge
    lj, lt = _losses(jout), _losses(tout)
    assert len(lt) == len(lj) == 2 and np.isfinite(lt).all()
    assert abs(lt[0] - lj[0]) <= 2e-5 * abs(lj[0]), (lt, lj)
    adapters = [_header(os.path.join(d, "adapters.safetensors")) for d in (jout, tout)]
    assert adapters[0] == adapters[1]
    assert adapters[1]["lm/layers/gate_proj/a"] == (2, 320, 8)
    assert adapters[1]["lm/layers/down_proj/b"] == (2, 8, 320)
    finals = [_header(os.path.join(d, "final", "model.safetensors")) for d in (jout, tout)]
    assert finals[0] == finals[1]
    assert finals[1]["model.layers.0.self_attn.q_proj.weight"] == (320, 320)
    _, jmodel, *_ = jb.load_pretrained_model(os.path.join(tout, "final"))
    _, tmodel, *_ = tb.load_pretrained_model(os.path.join(jout, "final"), device="cpu")
    assert jmodel.config.model_type == tmodel.config.model_type == "vcoder_it_llava"
    assert (jmodel.config.text.num_heads, tmodel.config.text.num_heads) == (40, 40)
    assert not isinstance(tmodel.params["lm"]["layers"]["q_proj"], tlora.LoraWeight)


def _bases(kind, w):
    if kind == "f32":
        return w
    if kind == "bf16":
        return w.to(torch.bfloat16)
    return tq.quantize(w, bits=8 if kind == "int8" else 4)


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8", "int4"])
def test_merge_one_layer_at_a_time_is_the_whole_stack_fold(kind):
    g = torch.Generator().manual_seed(3)
    L, i, o, r = 3, 320, 864, 16
    base = _bases(kind, torch.randn(L, i, o, generator=g))
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    a = torch.randn(L, i, r, generator=g).to(dt)
    b = (torch.randn(L, r, o, generator=g) * 0.1).to(dt)
    w = tlora.LoraWeight(base=base, a=a, b=b, scale=2.0)
    # The fold of the whole stack at once (the merge before it went by layer).
    full = tq.dequantize(base, dtype=dt) if isinstance(base, tq.QuantizedTensor) else base
    want = (full.float() + torch.einsum("...ir,...ro->...io", a.float(), b.float())
            * 2.0).to(full.dtype)
    got = tlora.merge_lora({"lm": {"layers": {"up_proj": w}}})["lm"]["layers"]["up_proj"]
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_merge_hands_fold_one_layer_at_a_time(monkeypatch):
    g = torch.Generator().manual_seed(4)
    L, i, o, r = 4, 64, 96, 8
    stacked = tlora.LoraWeight(torch.randn(L, i, o, generator=g), torch.randn(L, i, r),
                               torch.randn(L, r, o), 0.5)
    head = tlora.LoraWeight(torch.randn(i, o, generator=g), torch.randn(i, r),
                            torch.randn(r, o), 0.5)
    seen, fold = [], tlora._fold

    def spy(base, a, b, scale):
        seen.append(max((tuple(x.shape) for x in (base, a, b)),
                        key=lambda s: int(np.prod(s))))
        return fold(base, a, b, scale)

    monkeypatch.setattr(tlora, "_fold", spy)
    out = tlora.merge_lora({"lm": {"layers": {"gate_proj": stacked}, "lm_head": head}})
    assert seen == [(i, o)] * (L + 1)  # L layers of the stack, then the 2-D leaf whole
    assert tuple(out["lm"]["layers"]["gate_proj"].shape) == (L, i, o)


def test_merge_matches_jax_at_the_13b_layout():
    jcfg, tcfg = _narrow(JConfig), _narrow(TConfig)
    jp = jax.tree.map(jnp.asarray, _perturbed(jvcoder.init_vcoder_params(
        jax.random.PRNGKey(21), jcfg), 21))
    # Every field perturbed: b is no longer zero, so the merge moves each weight.
    jl = jax.tree.map(jnp.asarray, _perturbed(jlora.add_lora(jp, jax.random.PRNGKey(6), rank=8,
                                                             alpha=16.0), 22))
    want = _jax_flat(jlora.merge_lora(jl))
    tl = from_jax_params(jax.tree.map(np.asarray, jl), tcfg, device="cpu")
    got = {p: t.numpy() for p, t in named_leaves(tlora.merge_lora(tl))}
    assert set(got) == set(want) and got["lm/layers/gate_proj"].shape == (2, 320, 864)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert not np.allclose(got["lm/layers/q_proj"], np.asarray(jp["lm"]["layers"]["q_proj"]))
