"""Sharded training over a ``(data, fsdp, model)`` mesh: the port's step,
``Trainer`` and stage drivers on 4 gloo ranks against JAX's sharded step and
the port's one-device runs (CPU, f32).

* Three stage-3 steps at mesh ``(1, 2, 2)`` (parameters by the sharding
  rules, the batch's rows over ``fsdp``, heads and MLP width over ``model``,
  the flash route per rank under ``remat="dots"``) against JAX's step on the
  same mesh of 4 of its 8 virtual CPU devices and the port's one-device
  step: losses and the updated leaves within 1e-5 relative, the frozen
  leaves bit-equal to where they started (mirrors ``test_parallel.py:117``).
  Every rank reports the same losses and norms.
* The offloaded sharded step (each rank's moments in host memory, streamed)
  is bit-equal to the resident sharded step.
* ``Trainer`` over the group: losses equal to the one-device ``Trainer``'s
  within 1e-5 relative, rank 0's checkpoint, resume re-sharding it
  (the resumed run equal to the uninterrupted one), ``adapters.safetensors``.
* The stage driver under the group (``--mesh-fsdp 2 --mesh-model 2``,
  ``launch.in_torchrun`` as under torchrun) against its one-device run:
  losses within 1e-5 relative, ``final/`` loadable.
* LoRA (``lora`` and ``it_lora``, adapters from JAX's ``add_lora`` carried
  over by ``from_jax_params``, every field perturbed so ``a`` trains from
  the first step): three steps at ``(1, 2, 2)`` against JAX's sharded step
  and one device, losses and trained leaves within 1e-5 relative, the
  frozen base bit-equal; ``Trainer`` over the group resumes bit-exactly and
  its ``adapters.safetensors`` equals one device's within 1e-5; a LoRA over
  an int8 base (``W8A8_MIN_TOKENS`` lowered to 16, so every decoder product
  takes the W8A8 path, row-parallel ones reduced over ``model``) gets a
  non-zero gradient through the base, within 1e-3 of one device's; the
  ``it --lora-enable`` driver under the group writes ``adapters.safetensors``
  and a merged ``final/`` equal to one device's within 1e-5.

Rank bodies import no JAX; the JAX side runs in the test process.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from vcoder_tpu_torch.parallel import launch

torch.set_num_threads(1)

STAGE = "vcoder_ds"
MESH = (1, 2, 2)


def _samples(cfg, n=4):
    rng = np.random.RandomState(0)
    S = cfg.vision.image_size
    out = []
    for i in range(n):
        n_q, n_a = ((3, 6), (2, 3), (4, 5), (1, 7))[i % 4]
        prompt = [1] + list(rng.randint(3, 200, n_q)) + [-200, -400, -300, 17]
        answer = list(rng.randint(3, 200, n_a)) + [2]
        out.append(dict(
            input_ids=prompt + answer, labels=[-100] * len(prompt) + answer,
            **{m: rng.randn(S, S, 3).astype(np.float32) for m in ("image", "seg", "depth")}))
    return out


def _collate_kw(cfg):
    return dict(num_patches=cfg.vision.num_patches, ds_mode=True, use_seg=True,
                use_depth=True, image_size=cfg.vision.image_size, pad_multiple=16)


def _leaves_np(params):
    from torch.distributed.tensor import DTensor

    from vcoder_tpu_torch.tree import named_leaves

    return {p: (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy().copy()
            for p, t in named_leaves(params)}


def _port_steps(np_params, samples, mesh_shape, *, offload=False, n=3, stage=STAGE,
                quant_bits=None):
    """n steps of the port's step for ``stage`` (the stage-3 one by
    default); one device when ``mesh_shape`` is None; ``quant_bits``
    quantizes the tree first (LoRA over a quantized base). Returns (losses,
    grad norms, every leaf after)."""
    import contextlib

    from vcoder_tpu_torch.checkpoint import from_jax_params
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.parallel import make_mesh, use_mesh
    from vcoder_tpu_torch.parallel.sharding import (
        device_shardings_like,
        host_shardings,
        shard_batch,
        shard_params,
    )
    from vcoder_tpu_torch.train import step as tstep
    from vcoder_tpu_torch.train.collator import collate_batch

    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    params = from_jax_params(np_params, cfg, device="cpu")
    if quant_bits:
        from vcoder_tpu_torch.lora import LoraWeight
        from vcoder_tpu_torch.quant import quantize_params

        layers = params["lm"]["layers"]
        bases = quantize_params({"lm": {"layers": {k: v.base for k, v in layers.items()
                                                   if isinstance(v, LoraWeight)}}},
                                bits=quant_bits)["lm"]["layers"]
        for k, base in bases.items():
            layers[k].base = base
    batch = collate_batch(samples, device="cpu", **_collate_kw(cfg))
    opt = tstep.make_optimizer(1e-2, 10)
    ctx, sh = contextlib.nullcontext(), None
    if mesh_shape:
        mesh = make_mesh(data=mesh_shape[0], fsdp=mesh_shape[1], model=mesh_shape[2])
        shard_params(params, mesh)
        batch = shard_batch(batch, mesh)
        ctx = use_mesh(mesh)
    state = tstep.init_opt_state(params, opt, stage)
    if offload:
        host = host_shardings(state, mesh)
        state = {k: host[k].place(tstep._local(t)) for k, t in state.items()}
        sh = (device_shardings_like(host), host)
    step = tstep.make_train_step(cfg, opt, stage=stage, attn_impl="auto", remat="dots",
                                 offload_shardings=sh)
    losses, norms = [], []
    with ctx:
        for _ in range(n):
            params, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            norms.append([float(m["grad_norm"])] + [float(v) for v in
                                                   m["leaf_grad_norms"].values()])
    return losses, norms, _leaves_np(params)


def _trainer_run(np_params, out, mesh_shape, steps, resume, stage=STAGE):
    import contextlib

    import chip_smoke
    from vcoder_tpu_torch.checkpoint import from_jax_params
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.parallel import make_mesh, use_mesh
    from vcoder_tpu_torch.train.trainer import TrainArgs, Trainer

    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    params = from_jax_params(np_params, cfg, device="cpu")
    mesh = None
    if mesh_shape:
        mesh = make_mesh(data=mesh_shape[0], fsdp=mesh_shape[1], model=mesh_shape[2])
    rows = mesh.row_shards if mesh else 1
    args = TrainArgs(output_dir=out, per_device_train_batch_size=4 // rows, save_steps=2,
                     learning_rate=1e-2, dataloader_workers=0, attn_impl="auto", stage=stage)
    with use_mesh(mesh) if mesh else contextlib.nullcontext():
        tr = Trainer(cfg, params, chip_smoke.DSSamples(16, cfg.vision.image_size), args,
                     mesh=mesh, device="cpu")
        resumed = tr.maybe_resume() if resume else False
        hist = tr.train(max_steps=steps)
        tr.save_adapters()
    return dict(losses=[h["loss"] for h in hist], step=tr.step, resumed=resumed,
                leaves=_leaves_np(tr.params))


LORA_STAGES = ("lora", "it_lora")
W8A8_MIN_TOKENS = 16


def _lora_int8_steps(np_lora, samples, mesh_shape, base_dx=True):
    """Two ``it_lora`` steps over the int8 base with the W8A8 threshold
    lowered: (losses, grad norms, leaves, W8A8 products run).
    ``base_dx=False`` zeroes the base products' input gradient (what the
    W8A8 product's round() would give without its straight-through
    backward)."""
    from vcoder_tpu_torch.ops import quant as tq

    calls = []
    w8a8 = tq.w8a8_matmul
    tq.W8A8_MIN_TOKENS, before = W8A8_MIN_TOKENS, tq.W8A8_MIN_TOKENS
    tq.w8a8_matmul = lambda *a, **k: (calls.append(1), w8a8(*a, **k))[1]
    backward = tq._W8A8Matmul.backward
    if not base_dx:
        tq._W8A8Matmul.backward = staticmethod(
            lambda ctx, g: (torch.zeros(*g.shape[:-1], ctx.saved_tensors[0].shape[0]),
                            None, None, None))
    try:
        out = _port_steps(np_lora, samples, mesh_shape, n=2, stage="it_lora", quant_bits=8)
    finally:
        tq.W8A8_MIN_TOKENS, tq.w8a8_matmul = before, w8a8
        tq._W8A8Matmul.backward = backward
    return (*out, len(calls))


def _rank_body(rank, world, np_params, np_lora, samples, out_dir):
    torch.set_num_threads(1)
    res = {"resident": _port_steps(np_params, samples, MESH),
           "offloaded": _port_steps(np_params, samples, MESH, offload=True)}
    res["trainer"] = _trainer_run(np_params, os.path.join(out_dir, "mesh"), MESH, 3, False)
    res["resumed"] = _trainer_run(np_params, os.path.join(out_dir, "mesh"), MESH, 3, True)
    res["fresh"] = _trainer_run(np_params, os.path.join(out_dir, "mesh2"), MESH, 3, False)
    for stage in LORA_STAGES:
        res[stage] = _port_steps(np_lora, samples, MESH, stage=stage)
    res["lora_int8"] = _lora_int8_steps(np_lora, samples, MESH)
    lora_dir = os.path.join(out_dir, "lora_mesh")
    res["lora_trainer"] = _trainer_run(np_lora, lora_dir, MESH, 3, False, stage="lora")
    res["lora_resumed"] = _trainer_run(np_lora, lora_dir, MESH, 3, True, stage="lora")
    return res


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    import jax

    from vcoder_tpu.config import VCoderConfig as JConfig
    from vcoder_tpu.models import vcoder as jvcoder

    from vcoder_tpu.lora import add_lora

    jcfg = JConfig.tiny("vcoder_ds_llava")
    jp = jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(0)
    np_params = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32), jp)
    # JAX's adapters over the same weights, every field perturbed (b too).
    np_lora = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32),
        add_lora(jp, jax.random.PRNGKey(5), rank=8, alpha=16.0))
    samples = _samples(jcfg)
    out_dir = str(tmp_path_factory.mktemp("sharded_train"))
    ranks = launch.spawn(_rank_body, 4, np_params, np_lora, samples, out_dir, timeout_s=300)
    return dict(jcfg=jcfg, np_params=np_params, np_lora=np_lora, samples=samples,
                out_dir=out_dir, ranks=ranks)


@pytest.fixture(scope="module")
def jax_sharded(setup):
    """JAX's sharded step, three times, on (1, 2, 2) of its CPU devices."""
    return _jax_steps(setup, setup["np_params"], STAGE)


def _jax_steps(setup, np_params, stage):
    import jax

    from vcoder_tpu.models import vcoder as jvcoder  # noqa: F401
    from vcoder_tpu.parallel import make_mesh, shard_batch, shard_params
    from vcoder_tpu.parallel.sharding import _path_str
    from vcoder_tpu.train import step as jstep
    from vcoder_tpu.train.collator import collate_batch

    jcfg = setup["jcfg"]
    mesh = make_mesh(jax.devices()[:4], data=MESH[0], fsdp=MESH[1], model=MESH[2])
    params = shard_params(jax.tree.map(jax.numpy.asarray, np_params), mesh)
    batch = shard_batch(collate_batch(setup["samples"], as_jnp=True, **_collate_kw(jcfg)), mesh)
    opt = jstep.make_optimizer(1e-2, total_steps=10)
    state = jstep.init_opt_state(params, opt, stage)
    step = jstep.make_train_step(jcfg, opt, stage=stage, attn_impl="xla", remat=False)
    losses = []
    for _ in range(3):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    leaves = {_path_str(p): np.asarray(v)
              for p, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    return losses, leaves


@pytest.fixture(scope="module")
def one_device(setup):
    return _port_steps(setup["np_params"], setup["samples"], None)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / (np.abs(b).max() + 1e-12))


def _leaf(tree, path):
    import dataclasses

    for k in path.split("/"):
        if isinstance(tree, list):
            tree = tree[int(k)]
        elif dataclasses.is_dataclass(tree):
            tree = getattr(tree, k)
        else:
            tree = tree[k]
    return np.asarray(tree)


@pytest.mark.parametrize("stage", LORA_STAGES)
def test_lora_steps_match_jax_and_one_device(setup, stage):
    import re

    from vcoder_tpu_torch.train.step import STAGE_TRAINABLE

    losses, norms, leaves = setup["ranks"][0][stage]
    j_losses, j_leaves = _jax_steps(setup, setup["np_lora"], stage)
    one = _port_steps(setup["np_lora"], setup["samples"], None, stage=stage)
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    np.testing.assert_allclose(losses, one[0], rtol=1e-5)
    np.testing.assert_allclose(norms, one[1], rtol=1e-5)
    for res in setup["ranks"][1:]:
        assert res[stage][0] == losses and res[stage][1] == norms
    trained = [re.compile(p) for p in STAGE_TRAINABLE[stage]]
    moved = 0
    for path, got in leaves.items():
        assert _rel(got, j_leaves[path]) <= 1e-5, path
        assert _rel(got, one[2][path]) <= 1e-5, path
        start = _leaf(setup["np_lora"], path)
        if not any(p.match(path) for p in trained):
            np.testing.assert_array_equal(got, start, err_msg=path)
        elif path.endswith(("/a", "/b")):
            assert np.abs(got - start).max() > 0, path
            moved += 1
    assert moved == 14  # a and b of the seven decoder products


def test_lora_over_int8_base_gets_gradient_through_it(setup):
    from vcoder_tpu_torch.checkpoint import from_jax_params
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.train.step import trainable_leaves

    losses, norms, leaves, w8a8 = setup["ranks"][0]["lora_int8"]
    one = _lora_int8_steps(setup["np_lora"], setup["samples"], None)
    blind = _lora_int8_steps(setup["np_lora"], setup["samples"], None, base_dx=False)
    assert w8a8 > 0 and one[3] > 0
    np.testing.assert_allclose(losses, one[0], rtol=1e-3)
    np.testing.assert_allclose(norms, one[1], rtol=1e-3)
    # The seg projector feeds the decoder's input: its gradient takes the
    # base products' dx through their straight-through backward, over the
    # mesh as on one device; zeroing that dx moves it.
    tree = from_jax_params(setup["np_lora"], VCoderConfig.tiny("vcoder_ds_llava"), device="cpu")
    seg = [1 + i for i, p in enumerate(trainable_leaves(tree, "it_lora"))
           if p.startswith("seg_projector/")]
    assert len(seg) == 4 and all(norms[0][i] > 0 for i in seg)
    gap = max(abs(one[1][0][i] - blind[1][0][i]) / one[1][0][i] for i in seg)
    assert gap > 1e-2, gap
    for p in (p for p in leaves if p.startswith("seg_projector/")):
        assert _rel(leaves[p], one[2][p]) <= 1e-3, p


def test_lora_trainer_resumes_and_writes_adapters(setup, tmp_path):
    from vcoder_tpu_torch.checkpoint import read_safetensors

    res = setup["ranks"][0]
    ref = _trainer_run(setup["np_lora"], str(tmp_path / "one"), None, 3, False, stage="lora")
    np.testing.assert_allclose(res["lora_trainer"]["losses"], ref["losses"], rtol=1e-5)
    assert res["lora_resumed"]["resumed"] and res["lora_resumed"]["step"] == 3
    np.testing.assert_allclose(res["lora_resumed"]["losses"], res["lora_trainer"]["losses"][2:],
                               rtol=1e-6)
    for path, got in res["lora_resumed"]["leaves"].items():
        np.testing.assert_array_equal(got, res["lora_trainer"]["leaves"][path], err_msg=path)
    got = read_safetensors(os.path.join(setup["out_dir"], "lora_mesh", "adapters.safetensors"))
    want = read_safetensors(str(tmp_path / "one" / "adapters.safetensors"))
    assert set(got) == set(want) and any(k.endswith("/a") for k in got)
    for k in want:
        assert _rel(got[k].numpy(), want[k].numpy()) <= 1e-5, k


def test_every_rank_reports_the_same(setup):
    first = setup["ranks"][0]
    for res in setup["ranks"][1:]:
        for key in ("resident", "offloaded"):
            assert res[key][0] == first[key][0] and res[key][1] == first[key][1]
        assert res["trainer"]["losses"] == first["trainer"]["losses"]


def test_sharded_steps_match_jax_and_one_device(setup, jax_sharded, one_device):
    import re

    from vcoder_tpu_torch.train.step import STAGE_TRAINABLE

    losses, norms, leaves = setup["ranks"][0]["resident"]
    j_losses, j_leaves = jax_sharded
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    np.testing.assert_allclose(losses, one_device[0], rtol=1e-5)
    np.testing.assert_allclose(norms, one_device[1], rtol=1e-5)
    assert losses[2] < losses[0]
    trained = [re.compile(p) for p in STAGE_TRAINABLE[STAGE]]
    start = setup["np_params"]
    for path, got in leaves.items():
        assert _rel(got, j_leaves[path]) <= 1e-5, path
        assert _rel(got, one_device[2][path]) <= 1e-5, path
        frozen = not any(p.match(path) for p in trained)
        ref = functools.reduce(lambda t, k: t[int(k)] if isinstance(t, list) else t[k],
                               path.split("/"), start)
        if frozen:
            np.testing.assert_array_equal(got, ref, err_msg=path)
        elif not path.startswith("depth_projector"):  # depth goes through the seg projector
            assert np.abs(got - ref).max() > 0, path


def test_offloaded_sharded_step_is_bit_equal(setup):
    for res in setup["ranks"]:
        r_loss, r_norms, r_leaves = res["resident"]
        o_loss, o_norms, o_leaves = res["offloaded"]
        assert r_loss == o_loss and r_norms == o_norms
        for path in r_leaves:
            np.testing.assert_array_equal(o_leaves[path], r_leaves[path], err_msg=path)


def test_trainer_over_the_group_checkpoints_and_resumes(setup, tmp_path):
    ref = _trainer_run(setup["np_params"], str(tmp_path / "one"), None, 3, False)
    res = setup["ranks"][0]
    np.testing.assert_allclose(res["trainer"]["losses"], ref["losses"], rtol=1e-5)
    out = os.path.join(setup["out_dir"], "mesh")
    assert sorted(os.listdir(out)) == ["adapters.safetensors", "checkpoint-2",
                                       "metrics.jsonl"]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        # Rank 0 alone logs: the first run's 3 steps, then the resumed step.
        assert [json.loads(line)["step"] for line in f] == [1, 2, 3, 3]
    assert res["resumed"]["resumed"] and res["resumed"]["step"] == 3
    # Resumed from step 2 and re-sharded: step 3 as the uninterrupted run.
    np.testing.assert_allclose(res["resumed"]["losses"], res["fresh"]["losses"][2:], rtol=1e-6)
    for path, got in res["resumed"]["leaves"].items():
        np.testing.assert_array_equal(got, res["fresh"]["leaves"][path], err_msg=path)
    from vcoder_tpu_torch.checkpoint import read_safetensors

    adapters = read_safetensors(os.path.join(out, "adapters.safetensors"))
    assert set(adapters) == {"seg_projector/w/0", "seg_projector/w/1", "seg_projector/b/0",
                             "seg_projector/b/1", "depth_projector/w/0", "depth_projector/w/1",
                             "depth_projector/b/0", "depth_projector/b/1", "vcoder_lm_emb"}
    for k, t in adapters.items():
        np.testing.assert_array_equal(t.numpy(), res["resumed"]["leaves"][k], err_msg=k)


# ---------------------------------------------------------------------------
# The stage driver under the group
# ---------------------------------------------------------------------------


def _driver_body(rank, world, runs):
    import vcoder_tpu_torch.builder as tb
    from vcoder_tpu_torch.train import drivers as tdrv

    torch.set_num_threads(1)
    tb.load_pretrained_model = functools.partial(tb.load_pretrained_model, dtype=torch.float32)
    assert launch.in_torchrun()
    out = []
    for stage, argv in runs:
        tr = tdrv.run_stage(stage, tdrv.build_arg_parser().parse_args(argv))
        out.append(dict(step=tr.step, shape=tr.mesh.shape))
    return out


def test_stage_driver_under_the_group(tmp_path, monkeypatch):
    import jax

    import vcoder_tpu_torch.builder as tb
    from tests.test_torch_train_drivers import FLAGS, TEXT
    from tests.test_train_pipeline import _make_cost_tree
    from vcoder_tpu.checkpoint import save_pretrained as jsave
    from vcoder_tpu.config import VCoderConfig as JConfig
    from vcoder_tpu.models import vcoder as jvcoder
    from vcoder_tpu.simple_tokenizer import SimpleTokenizer as JTokenizer
    from vcoder_tpu_torch.builder import load_pretrained_model
    from vcoder_tpu_torch.train import drivers as tdrv

    root = str(tmp_path / "cost")
    os.makedirs(root)
    _make_cost_tree(root)
    base = str(tmp_path / "vcoder_ds_llava-tiny")
    cfg = JConfig.tiny("vcoder_ds_llava")
    jsave(base, jvcoder.init_vcoder_params(jax.random.PRNGKey(0), cfg), cfg)
    JTokenizer.build_from_texts([TEXT]).save_pretrained(base)

    def argv(out, per_device, mesh):
        return (["--model-path", base, "--output-dir", out, "--seg-data-path", root,
                 "--depth-data-path", root, "--image-folder", root, "--device", "cpu"]
                + FLAGS + ["--per-device-train-batch-size", str(per_device)] + mesh)

    monkeypatch.setattr(tb, "load_pretrained_model",
                        functools.partial(load_pretrained_model, dtype=torch.float32))
    lora = ["--lora-enable", "--lora-r", "4", "--lora-alpha", "8"]
    one, one_lora = str(tmp_path / "one"), str(tmp_path / "one_lora")
    single = ["--mesh-data", "1", "--mesh-fsdp", "1", "--mesh-model", "1"]
    tdrv.run_stage(STAGE, tdrv.build_arg_parser().parse_args(argv(one, 2, single)))
    tdrv.run_stage("it", tdrv.build_arg_parser().parse_args(argv(one_lora, 2, single + lora)))
    mesh_out, mesh_lora = str(tmp_path / "mesh"), str(tmp_path / "mesh_lora")
    split = ["--mesh-fsdp", "2", "--mesh-model", "2"]
    res = launch.spawn(_driver_body, 4, [(STAGE, argv(mesh_out, 1, split)),
                                         ("it", argv(mesh_lora, 1, split + lora))],
                       timeout_s=300)
    assert [r["step"] for rank in res for r in rank] == [2] * 8
    assert res[0][0]["shape"] == {"data": 1, "fsdp": 2, "model": 2}

    def losses(out):
        with open(os.path.join(out, "metrics.jsonl")) as f:
            return [json.loads(line)["loss"] for line in f]

    np.testing.assert_allclose(losses(mesh_out), losses(one), rtol=1e-5)
    assert sorted(os.listdir(mesh_out)) == sorted(os.listdir(one))
    _, model, *_ = load_pretrained_model(os.path.join(mesh_out, "final"), device="cpu",
                                         dtype=torch.float32)
    _, ref, *_ = load_pretrained_model(os.path.join(one, "final"), device="cpu",
                                       dtype=torch.float32)
    got, want = _leaves_np(model.params), _leaves_np(ref.params)
    assert set(got) == set(want)
    for path in want:
        assert _rel(got[path], want[path]) <= 1e-5, path
    # --lora-enable under the group: the same adapters (drawn whole from
    # seed + 17, then sharded), losses, adapters.safetensors and merged
    # final/ as one device.
    from vcoder_tpu_torch.checkpoint import read_safetensors

    np.testing.assert_allclose(losses(mesh_lora), losses(one_lora), rtol=1e-5)
    a_got = read_safetensors(os.path.join(mesh_lora, "adapters.safetensors"))
    a_want = read_safetensors(os.path.join(one_lora, "adapters.safetensors"))
    assert set(a_got) == set(a_want) and "lm/layers/down_proj/a" in a_want
    for k in a_want:
        # b (and the projector biases) start at zero here, and Adam's first
        # updates divide each gradient by its own magnitude: the f32 partial
        # sums over model, added in another order, read up to ~5e-5 there.
        assert _rel(a_got[k].numpy(), a_want[k].numpy()) <= 1e-4, k
    _, model, *_ = load_pretrained_model(os.path.join(mesh_lora, "final"), device="cpu",
                                         dtype=torch.float32)
    _, ref, *_ = load_pretrained_model(os.path.join(one_lora, "final"), device="cpu",
                                       dtype=torch.float32)
    got, want = _leaves_np(model.params), _leaves_np(ref.params)
    assert set(got) == set(want) and "lm/layers/q_proj" in want  # merged: plain weights
    for path in want:  # biases that start at zero as b does: 1e-4, as above
        assert _rel(got[path], want[path]) <= 1e-4, path
