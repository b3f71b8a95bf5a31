"""The port's stage-3 training step against the JAX package on the CPU.

Weights: ``vcoder_tpu.models.vcoder.init_vcoder_params`` on
``VCoderConfig.tiny("vcoder_ds_llava")``, perturbed so norms, biases and the
``vcoder_lm_emb`` table differ from their init values, bridged with
``from_jax_params``. One batch of two right-padded DS samples (image + seg +
depth pixels from a numpy seed) is collated by both packages. The JAX side
runs its ``xla`` attention; the port runs ``xla`` and ``auto`` (the flash
Function, whose CPU backward is the plain version of the K6 kernels), under
each ``remat``. Tolerances (f32): the loss 1e-5 relative; gradients 1e-6
absolute + 1e-4 relative; after four optimizer steps, parameters and Adam
moments 1e-6 absolute + 1e-4 relative (f32 sums in other orders; ``pow`` and
``cos`` of the bias corrections and the schedule may differ in the last ulp).

Also here: the stage masks against JAX's for every stage, the guards that
keep autograd out of the kernels without a backward, the frozen tower's
no-grad pass, and the adapter bootstrap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.parallel.sharding import _path_str
from vcoder_tpu.train import step as jstep
from vcoder_tpu.train.collator import collate_batch as j_collate
from vcoder_tpu_torch.checkpoint import from_jax_params
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.models import clip as tclip
from vcoder_tpu_torch.models import vcoder as tvcoder
from vcoder_tpu_torch.ops import _kernels
from vcoder_tpu_torch.train import step as tstep
from vcoder_tpu_torch.train.collator import collate_batch as t_collate
from vcoder_tpu_torch.tree import named_leaves

torch.set_num_threads(1)

STAGE = "vcoder_ds"


def _samples(cfg):
    """Two DS samples in the order ``tokenizer_depth_seg_token`` emits the
    sentinels ([-200, -400, -300]), the prompt masked out of the labels."""
    rng = np.random.RandomState(0)
    S = cfg.vision.image_size
    out = []
    for n_q, n_a in ((3, 6), (2, 3)):
        prompt = [1] + list(rng.randint(3, 200, n_q)) + [-200, -400, -300, 17]
        answer = list(rng.randint(3, 200, n_a)) + [2]
        out.append(dict(
            input_ids=prompt + answer,
            labels=[-100] * len(prompt) + answer,
            **{m: rng.randn(S, S, 3).astype(np.float32) for m in ("image", "seg", "depth")},
        ))
    return out


def _collate_kw(cfg):
    return dict(num_patches=cfg.vision.num_patches, ds_mode=True, use_seg=True,
                use_depth=True, image_size=cfg.vision.image_size, pad_multiple=16)


@pytest.fixture(scope="module")
def setup():
    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(0)
    np_params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), jp
    )
    samples = _samples(jcfg)
    jbatch = j_collate(samples, as_jnp=True, **_collate_kw(jcfg))
    tbatch = t_collate(samples, device="cpu", **_collate_kw(tcfg))
    return jcfg, tcfg, np_params, jbatch, tbatch


def _jax_params(np_params):
    return jax.tree.map(jnp.asarray, np_params)


def _port_params(np_params, tcfg):
    return from_jax_params(np_params, tcfg, device="cpu")


def _jax_loss_and_grads(jcfg, np_params, jbatch):
    jp = _jax_params(np_params)
    tp, fp = jstep.partition(jp, jstep.trainable_mask(jp, STAGE))

    def loss_fn(tp):
        return jvcoder.train_forward(
            jstep.combine(tp, fp), jcfg, jbatch, jbatch["images"], jbatch["segs"],
            jbatch["depths"], use_vcoder_emb=True, attn_impl="xla", remat=False,
        )

    loss, grads = jax.value_and_grad(loss_fn)(tp)
    flat = {_path_str(p): np.asarray(g) for p, g in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return float(loss), flat


@pytest.fixture(scope="module")
def jax_reference(setup):
    jcfg, _, np_params, jbatch, _ = setup
    return _jax_loss_and_grads(jcfg, np_params, jbatch)


def test_collated_batches_match(setup):
    _, _, _, jbatch, tbatch = setup
    assert set(jbatch) == set(tbatch)
    for key in jbatch:
        np.testing.assert_array_equal(tbatch[key].numpy(), np.asarray(jbatch[key]), err_msg=key)


@pytest.mark.parametrize("attn_impl", ["xla", "auto"])
@pytest.mark.parametrize("remat", [False, True, "dots"], ids=["remat_off", "remat_on", "dots"])
def test_loss_and_trainable_grads_match_jax(setup, jax_reference, remat, attn_impl):
    _, tcfg, np_params, _, tbatch = setup
    j_loss, j_grads = jax_reference
    tp = _port_params(np_params, tcfg)
    leaves = tstep.trainable_leaves(tp, STAGE)
    assert set(leaves) == set(j_grads)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = tvcoder.train_forward(
        tp, tcfg, tbatch, tbatch["images"], tbatch["segs"], tbatch["depths"],
        use_vcoder_emb=True, attn_impl=attn_impl, remat=remat,
    )
    np.testing.assert_allclose(loss.item(), j_loss, rtol=1e-5)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    for (path, t), g in zip(leaves.items(), grads):
        g = torch.zeros_like(t) if g is None else g
        np.testing.assert_allclose(g.numpy(), j_grads[path], atol=1e-6, rtol=1e-4, err_msg=path)
    # Depth goes through the seg projector: its own projector gets nothing.
    assert not np.any(j_grads["depth_projector/w/0"])
    assert np.any(j_grads["seg_projector/w/0"]) and np.any(j_grads["vcoder_lm_emb"])


@pytest.mark.parametrize("stage", sorted(jstep.STAGE_TRAINABLE))
def test_trainable_mask_matches_jax(setup, stage):
    _, tcfg, np_params, _, _ = setup
    assert tstep.STAGE_TRAINABLE == jstep.STAGE_TRAINABLE
    jmask = jstep.trainable_mask(_jax_params(np_params), stage)
    jflat = {_path_str(p): bool(m) for p, m in jax.tree_util.tree_flatten_with_path(jmask)[0]}
    assert tstep.trainable_mask(_port_params(np_params, tcfg), stage) == jflat


def _jax_opt_state_flat(opt_state):
    """optax state -> the port's flat keys (``count``, ``mu/<path>``,
    ``nu/<path>``, ``acc/<path>``, ``mini_step``, ``gradient_step``)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        names = [getattr(p, "name", None) for p in path]
        for field, key in (("mu", "mu"), ("nu", "nu"), ("acc_grads", "acc")):
            if field in names:
                out[f"{key}/{_path_str(path[names.index(field) + 1:])}"] = np.asarray(leaf)
                break
        else:
            if names[-1] in ("count", "mini_step", "gradient_step"):
                out.setdefault(names[-1], []).append(int(leaf))
    return out


OPT_CASES = {
    "first_step_lr0": dict(),
    "clipping_engages": dict(max_grad_norm=1e-3),
    "accum_steps_2": dict(accum_steps=2),
    "weight_decay": dict(weight_decay=0.1),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_four_steps_match_optax(setup, case):
    jcfg, tcfg, np_params, jbatch, tbatch = setup
    kw = dict(lr=1e-3, total_steps=10, **OPT_CASES[case])
    lr, total = kw.pop("lr"), kw.pop("total_steps")
    jopt = jstep.make_optimizer(lr, total, **kw)
    jp = _jax_params(np_params)
    jstate = jstep.init_opt_state(jp, jopt, STAGE)
    jfn = jstep.make_train_step(jcfg, jopt, stage=STAGE, attn_impl="xla", remat=False)
    topt = tstep.make_optimizer(lr, total, **kw)
    tp = _port_params(np_params, tcfg)
    tstate = tstep.init_opt_state(tp, topt, STAGE)
    tfn = tstep.make_train_step(tcfg, topt, stage=STAGE, attn_impl="auto", remat="dots")
    initial = {p: t.clone() for p, t in tstep.trainable_leaves(tp, STAGE).items()}
    for i in range(4):
        jp, jstate, jm = jfn(jp, jstate, jbatch)
        tp, tstate, tm = tfn(tp, tstate, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        if i == 0:  # optax reads the schedule before the increment: lr 0
            assert all(torch.equal(t, initial[p])
                       for p, t in tstep.trainable_leaves(tp, STAGE).items())
    jflat = {_path_str(p): np.asarray(x) for p, x in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for path, t in named_leaves(tp):
        np.testing.assert_allclose(t.detach().numpy(), jflat[path], atol=1e-6, rtol=1e-4,
                                   err_msg=path)
    moved = tstep.trainable_leaves(tp, STAGE)
    assert not torch.equal(moved["seg_projector/w/0"], initial["seg_projector/w/0"])
    jstate_flat = _jax_opt_state_flat(jstate)
    for key, t in tstate.items():
        if key in ("count", "mini_step", "gradient_step"):
            assert set(jstate_flat[key]) == {int(t)}, key
        else:
            np.testing.assert_allclose(t.numpy(), jstate_flat[key], atol=1e-6, rtol=1e-4,
                                       err_msg=key)
    assert {k for k in jstate_flat} == set(tstate)


def test_schedule_matches_optax():
    for total, ratio in ((10, 0.03), (200, 0.03), (50, 0.2)):
        warmup = max(int(total * ratio), 1)
        ref = optax.warmup_cosine_decay_schedule(0.0, 2e-3, warmup, max(total, warmup + 1), 0.0)
        opt = tstep.make_optimizer(2e-3, total, warmup_ratio=ratio)
        # f32 cos may differ in its last ulp; near the end of the decay
        # 1 + cos cancels, so the bound is 1e-6 of the peak, not relative.
        for count in range(total + 3):
            np.testing.assert_allclose(float(opt.schedule(count)), float(ref(count)),
                                       rtol=1e-6, atol=2e-9)


# ---------------------------------------------------------------------------
# Kernels without a backward raise under autograd
# ---------------------------------------------------------------------------


class _OnCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: it takes a wrapper down its
    kernel branch, where the guard must stop it before any launch."""

    @property
    def device(self):
        return torch.device("cuda")


def _cuda(t, grad=False):
    return torch.Tensor._make_subclass(_OnCuda, t, grad)


def _wrapper_calls():
    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8
    from vcoder_tpu_torch.ops import paged_attention as pa
    from vcoder_tpu_torch.ops import vit_attention as va

    f = lambda *s: _cuda(torch.zeros(s), grad=True)
    i = lambda *s: _cuda(torch.zeros(s, dtype=torch.int8))
    table, lengths = torch.zeros((2, 2), dtype=torch.int32), torch.ones(2, dtype=torch.int32)
    return {
        "fused_block_attention": lambda: va.fused_block_attention(
            f(1, 5, 16), f(16, 48), f(48), f(16, 16), n_heads=2),
        "carry_paged_attention_multi": lambda: pa.carry_paged_attention_multi(
            f(2, 1, 2, 8), f(1, 3, 2, 8, 8), f(1, 3, 2, 8, 8), table, lengths, 0, window=1),
        "carry_paged_attention_multi_q8": lambda: pa.carry_paged_attention_multi_q8(
            f(2, 1, 2, 8), i(1, 3, 2, 8, 8), i(1, 3, 2, 8, 8), f(1, 3, 2, 8), f(1, 3, 2, 8),
            table, lengths, 0, window=1),
        "paged_attention": lambda: pa.paged_attention(
            f(2, 2, 8), f(3, 2, 8, 8), f(3, 2, 8, 8), table, lengths),
        "int4_matmul": lambda: i4.int4_matmul(f(2, 8), i(4, 6)),
        "int8_mm": lambda: i8.int8_mm(i(2, 8), i(8, 6)),
        "flash_fwd": lambda: fa.flash_fwd(f(1, 4, 2, 8), f(1, 4, 2, 8), f(1, 4, 2, 8),
                                          causal=True),
        "flash_bwd": lambda: fa.flash_bwd(f(1, 4, 2, 8), f(1, 4, 2, 8), f(1, 4, 2, 8),
                                          f(1, 4, 2, 8), f(1, 2, 4), f(1, 4, 2, 8),
                                          causal=True),
    }


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_kernel_wrapper_reaches_the_guard_before_launching(name, monkeypatch):
    seen = []

    def guard(what, *tensors):
        seen.append(what)
        raise LookupError(what)

    monkeypatch.setattr(_kernels, "forbid_grad", guard)
    with pytest.raises(LookupError):
        _wrapper_calls()[name]()
    assert seen == [name]


def test_guard_raises_only_under_autograd():
    w = torch.zeros(3, requires_grad=True)
    x = torch.zeros(3)
    with pytest.raises(RuntimeError, match="no backward"):
        _kernels.forbid_grad("k", x, w)
    _kernels.forbid_grad("k", x, x)  # nothing requires grad
    with torch.no_grad():
        _kernels.forbid_grad("k", x, w)
    assert _kernels.needs_grad(x, w) and not _kernels.needs_grad(x, None)
    # A wrapper on its kernel branch with a differentiated input refuses.
    from vcoder_tpu_torch.ops import int4_matmul as i4

    with pytest.raises(RuntimeError, match="int4_matmul: this kernel has no backward"):
        i4.int4_matmul(_cuda(torch.zeros(2, 8), grad=True), _cuda(torch.zeros(4, 6, dtype=torch.int8)))


# ---------------------------------------------------------------------------
# The tower, the adapter bootstrap, the step's options
# ---------------------------------------------------------------------------


def test_frozen_tower_runs_without_grad(setup, monkeypatch):
    _, tcfg, np_params, _, tbatch = setup
    tp = _port_params(np_params, tcfg)
    for t in tstep.trainable_leaves(tp, STAGE).values():
        t.requires_grad_(True)
    modes, routes = [], []
    real_encode, real_eligible = tclip.clip_encode, tclip._fused_eligible
    monkeypatch.setattr(tclip, "clip_encode", lambda *a, **k: (
        modes.append(torch.is_grad_enabled()), real_encode(*a, **k))[1])
    monkeypatch.setattr(tclip, "_fused_eligible", lambda *a: (
        routes.append(real_eligible(*a)), routes[-1])[1])
    table = tvcoder.encode_vision(tp, tcfg, tbatch["images"], tbatch["segs"], tbatch["depths"])
    assert modes == [False] and routes == [True]
    assert table.grad_fn is not None  # the projectors after the tower are in the graph

    # A stage that trains the tower: grad mode on, the unfused route, and
    # gradients reach the tower's weights.
    for t in tstep.trainable_leaves(tp, "all").values():
        t.requires_grad_(True)
    modes.clear()
    routes.clear()
    table = tvcoder.encode_vision(tp, tcfg, tbatch["images"], tbatch["segs"], tbatch["depths"])
    assert modes == [True] and routes == [False]
    (g,) = torch.autograd.grad(table.sum(), [tp["vision_tower"]["layers"]["q_proj"]])
    assert torch.isfinite(g).all() and g.abs().sum() > 0


def test_initialize_missing_modules_matches_jax_structure():
    jcfg = JConfig.tiny("vcoder_ds_llava")
    tcfg = TConfig.tiny("vcoder_ds_llava")
    base = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), JConfig.tiny("llava"))
    jfull = jvcoder.initialize_missing_modules(dict(base), jcfg, jax.random.PRNGKey(1))
    tbase = from_jax_params(jax.tree.map(np.asarray, base), TConfig.tiny("llava"), device="cpu")
    tfull = tvcoder.initialize_missing_modules(dict(tbase), tcfg, seed=1)
    jshapes = {_path_str(p): tuple(x.shape)
               for p, x in jax.tree_util.tree_flatten_with_path(jfull)[0]}
    assert {p: tuple(t.shape) for p, t in named_leaves(tfull)} == jshapes
    assert torch.equal(tfull["vcoder_lm_emb"], tfull["lm"]["embed_tokens"])
    assert tfull["vcoder_lm_emb"].data_ptr() != tfull["lm"]["embed_tokens"].data_ptr()
    assert all(torch.equal(a, b) for a, b in zip(tfull["mm2_projector"]["w"],
                                                 tfull["mm_projector"]["w"]))
    it = tvcoder.initialize_missing_modules(
        dict(tbase), dataclasses.replace(TConfig.tiny("vcoder_it_llava")), seed=1)
    assert torch.equal(it["seg_projector"]["w"][0], tbase["mm_projector"]["w"][0])


def test_multi_device_offload_and_cached_remat_raise(setup):
    """An opt-state offload over a plain mesh of two devices raises (one
    device is ``test_torch_offload.py``'s; a process group places each
    rank's shards), placements on two devices within one process raise, and
    so does remat with a KV cache."""
    from vcoder_tpu_torch.parallel import Placement, host_shardings, make_mesh

    _, tcfg, _, _, _ = setup
    with pytest.raises(NotImplementedError, match="multi-device.*torch.distributed.run"):
        host_shardings({"mu/x": torch.zeros(2)}, make_mesh(["cpu", "cpu"]))
    # Over a spawned group each rank places its own shard on the host.
    from tests.test_torch_sharding import host_shardings_rank
    from vcoder_tpu_torch.parallel import launch

    got = launch.spawn(host_shardings_rank, 2, timeout_s=120)
    for r, (placements, shard, where) in enumerate(got):
        assert placements == {"mu/x": ("cpu", "unpinned_host"), "count": ("cpu", "device")}
        assert shard == [4.0 * r + i for i in range(4)] and where == "cpu"
    two = {"mu/a": Placement(torch.device("cpu"), "device"),
           "mu/b": Placement(torch.device("cuda", 1), "device")}
    with pytest.raises(NotImplementedError, match="one device"):
        tstep.make_train_step(tcfg, tstep.make_optimizer(1e-3, 10), offload_shardings=(two, two))
    with pytest.raises(ValueError, match="cache-free"):
        from vcoder_tpu_torch.models import llama as tllama

        tllama.llama_forward({"layers": {"q_proj": torch.zeros(1, 1, 1)}}, tcfg.text,
                             torch.zeros(1, 1, 32), attn_mask=torch.ones(1, 1, dtype=torch.bool),
                             position_ids=torch.zeros(1, 1, dtype=torch.long),
                             cache=object(), remat=True)
