"""The port's ``Trainer`` against the JAX package's on the CPU.

Both trainers read the same dataset, the JAX package's ``VCoderDataset``
over a synthetic COST tree (the port's ``Trainer`` takes any object with its
interface), with the same seed, batch size and schedule, from the same
weights (``from_jax_params``). The JAX side runs its ``xla`` attention without
remat; the port its flash route (the plain versions on the CPU) with
``remat="dots"``. Tolerances (f32): losses and grad norms 1e-5 relative;
adapter values 1e-6 absolute + 1e-4 relative. Resume is held to bit
equality, port against port. The collator, sampler and preprocessing copies
are held to equality with the JAX modules on the same samples.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.train import preprocess as jpre
from vcoder_tpu.train import sampler as jsampler
from vcoder_tpu.train.collator import collate_batch as j_collate
from vcoder_tpu.train.datasets import VCoderDataset, build_seg_cost_entries
from vcoder_tpu.train.trainer import TrainArgs as JTrainArgs
from vcoder_tpu.train.trainer import Trainer as JTrainer
from vcoder_tpu_torch.checkpoint import from_jax_params, read_safetensors
from vcoder_tpu_torch.config import VCoderConfig as TConfig
from vcoder_tpu_torch.train import preprocess as tpre
from vcoder_tpu_torch.train import sampler as tsampler
from vcoder_tpu_torch.train.collator import collate_batch as t_collate
from vcoder_tpu_torch.train.trainer import TrainArgs, Trainer, bucket_length
from vcoder_tpu_torch.tree import named_leaves

torch.set_num_threads(1)

KEYS = [f"img{i}.jpg" for i in range(6)]


def _make_cost_tree(root):
    """A synthetic COST tree (a copy of ``tests/test_train_pipeline.py``'s)."""
    from PIL import Image

    rng = np.random.RandomState(0)
    for bucket in ("train", "unlabeled", "test"):
        segm = os.path.join(root, "coco_segm_text", bucket)
        os.makedirs(segm, exist_ok=True)
        for task in ("panoptic", "semantic", "instance"):
            with open(os.path.join(segm, f"{task}.txt"), "w") as f:
                for k in KEYS:
                    f.write(
                        f"<IMG>{k}<IMG>The objects present in the image"
                        f" are: two people, a car, wall ({task})\n"
                    )
            inf_dir = os.path.join(segm, f"{task}_inference")
            os.makedirs(inf_dir, exist_ok=True)
            for k in KEYS:
                Image.fromarray(
                    rng.randint(0, 255, (48, 64, 3), np.uint8)
                ).save(os.path.join(inf_dir, k))
        ddir = os.path.join(root, "coco_segm_text", "depth", bucket)
        os.makedirs(os.path.join(ddir, "depth"), exist_ok=True)
        with open(os.path.join(ddir, "panoptic_order.txt"), "w") as f:
            for k in KEYS:
                f.write(
                    f"<IMG>{k}<IMG>The depth order for the objects present"
                    f" in the image is: person, car, wall\n"
                )
        for k in KEYS:
            Image.fromarray(
                rng.randint(0, 255, (48, 64, 3), np.uint8)
            ).save(os.path.join(ddir, "depth", k))
        img_dir = os.path.join(root, "coco", f"{bucket}2017")
        os.makedirs(img_dir, exist_ok=True)
        for k in KEYS:
            Image.fromarray(
                rng.randint(0, 255, (48, 64, 3), np.uint8)
            ).save(os.path.join(img_dir, k))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    from tests.conftest import FakeTokenizer

    root = str(tmp_path_factory.mktemp("cost"))
    _make_cost_tree(root)
    jcfg = JConfig.tiny("vcoder_ds_llava")
    entries = build_seg_cost_entries(root, buckets=("train",), seed=0, with_depth=True)
    tok = FakeTokenizer()
    ds = VCoderDataset(entries, tok, image_folder=root, seg_data_path=root,
                       depth_data_path=root, image_size=jcfg.vision.image_size,
                       use_seg=True, use_depth=True, model_max_length=jcfg.model_max_length)
    params = jax.tree.map(np.asarray, jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, TConfig.tiny("vcoder_ds_llava"), ds, tok, params


def _args(cls, out, **kw):
    base = dict(output_dir=str(out), stage="vcoder_ds", learning_rate=1e-3,
                per_device_train_batch_size=2, num_train_epochs=1, save_steps=2)
    return cls(**{**base, **kw})


def test_trainer_matches_jax(data, tmp_path):
    jcfg, tcfg, ds, _, params = data
    jt = JTrainer(jcfg, jax.tree.map(jax.numpy.asarray, params), ds,
                  _args(JTrainArgs, tmp_path / "jax", attn_impl="xla", remat=False))
    j_hist = jt.train(max_steps=3)
    tt = Trainer(tcfg, from_jax_params(params, tcfg, device="cpu"), ds,
                 _args(TrainArgs, tmp_path / "port", attn_impl="auto", remat="dots"),
                 device="cpu")
    t_hist = tt.train(max_steps=3)
    assert [h["step"] for h in t_hist] == [1, 2, 3] == [h["step"] for h in j_hist]
    for a, b in zip(t_hist, j_hist):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-5)
    # checkpoint-2 (save_steps), metrics.jsonl, adapters under JAX's keys.
    assert os.path.exists(tmp_path / "port" / "checkpoint-2" / "state.safetensors")
    lines = (tmp_path / "port" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(l)["step"] for l in lines] == [1, 2, 3]
    assert set(json.loads(lines[0])) == set(j_hist[0])
    ours = read_safetensors(tt.save_adapters())
    theirs = read_safetensors(jt.save_adapters())
    assert sorted(ours) == sorted(theirs)
    assert {"seg_projector/w/0", "depth_projector/b/1", "vcoder_lm_emb"} <= set(ours)
    for k in theirs:
        np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(), atol=1e-6, rtol=1e-4,
                                   err_msg=k)


def test_resume_is_bit_exact(data, tmp_path):
    """Two steps, then a fresh trainer with other weights resumes from
    checkpoint-2 and runs to four: its params and optimizer state equal an
    uninterrupted four-step run's exactly."""
    _, tcfg, ds, _, params = data
    other = jax.tree.map(np.asarray, jvcoder.init_vcoder_params(jax.random.PRNGKey(9),
                                                                JConfig.tiny("vcoder_ds_llava")))

    def trainer(sub, p):
        return Trainer(tcfg, from_jax_params(p, tcfg, device="cpu"), ds,
                       _args(TrainArgs, tmp_path / sub, num_train_epochs=2), device="cpu")

    straight = trainer("straight", params)
    straight.train(max_steps=4)
    first = trainer("resumed", params)
    first.train(max_steps=2)
    assert not trainer("empty", params).maybe_resume()
    second = trainer("resumed", other)
    assert second.maybe_resume() and second.step == 2
    second.train(max_steps=4)
    for (pa, a), (pb, b) in zip(named_leaves(straight.params), named_leaves(second.params)):
        assert pa == pb and torch.equal(a, b), pa
    assert straight.opt_state.keys() == second.opt_state.keys()
    for k in straight.opt_state:
        assert torch.equal(straight.opt_state[k], second.opt_state[k]), k
    # save_total_limit=1: only the newest checkpoint stays.
    assert sorted(os.listdir(tmp_path / "resumed")) == [
        "checkpoint-4", "metrics.jsonl"]


def test_prefetch_thread_is_joined(data, tmp_path):
    _, tcfg, ds, _, params = data
    tt = Trainer(tcfg, from_jax_params(params, tcfg, device="cpu"), ds,
                 _args(TrainArgs, tmp_path, prefetch_batches=1), device="cpu")
    tt.train(max_steps=1)
    assert tt.step == 1
    assert tt.prefetch_thread is not None and not tt.prefetch_thread.is_alive()


def test_trainer_multi_device_mesh_raises(data, tmp_path):
    """A plain mesh of two devices raises, with or without the opt-state
    offload (a one-device mesh and the offload are ``test_torch_offload.py``'s),
    and so do params off the device; over a spawned group of two ranks the
    trainer's steps are the one-device steps."""
    from vcoder_tpu_torch.parallel import make_mesh

    _, tcfg, ds, _, params = data
    p = from_jax_params(params, tcfg, device="cpu")
    two = make_mesh(["cpu", "cpu"])
    with pytest.raises(NotImplementedError, match="multi-device.*torch.distributed.run"):
        Trainer(tcfg, p, ds, _args(TrainArgs, tmp_path), mesh=two, device="cpu")
    with pytest.raises(NotImplementedError, match="multi-device.*torch.distributed.run"):
        Trainer(tcfg, p, ds, _args(TrainArgs, tmp_path, offload_opt_state=True), mesh=two,
                device="cpu")
    # Over a spawned group of two ranks (1, 2, 1) the trainer takes the
    # one-device steps, resident or offloaded.
    import chip_smoke
    from tests.test_torch_sharding import tiny_params, trainer_rank
    from vcoder_tpu_torch.parallel import launch
    from vcoder_tpu_torch.train.step import trainable_leaves

    cfg, tp = tiny_params()
    one = Trainer(cfg, tp, chip_smoke.DSSamples(8, cfg.vision.image_size),
                  _args(TrainArgs, tmp_path, per_device_train_batch_size=2,
                        learning_rate=1e-2, save_steps=10), device="cpu")
    want = [h["loss"] for h in one.train(max_steps=2)]
    for offload in (False, True):
        for losses, leaves in launch.spawn(trainer_rank, 2, offload,
                                           str(tmp_path / f"mesh-{offload}"), timeout_s=120):
            np.testing.assert_allclose(losses, want, rtol=1e-5)
            for path, t in trainable_leaves(one.params, "vcoder_ds").items():
                np.testing.assert_allclose(leaves[path], t.detach().numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=path)
    with pytest.raises(ValueError, match="params lie off"):
        Trainer(tcfg, {**p, "vcoder_lm_emb": p["vcoder_lm_emb"].to("meta")}, ds,
                _args(TrainArgs, tmp_path), device="cpu")


def test_collator_matches_jax_on_dataset_samples(data):
    jcfg, _, ds, _, _ = data
    samples = [ds[i] for i in range(3)]
    kw = dict(num_patches=jcfg.vision.num_patches, ds_mode=True, use_seg=True, use_depth=True,
              image_size=jcfg.vision.image_size, pad_to=bucket_length(40))
    ref = j_collate(samples, as_jnp=False, **kw)
    got = t_collate(samples, device="cpu", **kw)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("group_by_modality", [True, False])
@pytest.mark.parametrize("world,batch", [(1, 2), (2, 3)])
def test_sampler_matches_jax(group_by_modality, world, batch):
    lengths = [10, -5, 8, -3, 12, 7, -9, 11, 4, 6, -2, 13]
    for epoch in range(3):
        a = jsampler.LengthGroupedSampler(batch, world, lengths, seed=3,
                                          group_by_modality=group_by_modality)
        b = tsampler.LengthGroupedSampler(batch, world, lengths, seed=3,
                                          group_by_modality=group_by_modality)
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        assert list(a) == list(b)


PROMPTS = {
    "depth_seg": "<depth>\n<seg>\n<image>\nWhat objects are there?",
    "seg": "<seg>\n<image>\nWhat objects are there?",
    "image": "What is shown?\n<image>",
    "text": "Describe a car.",
}


@pytest.mark.parametrize("mode", sorted(PROMPTS))
def test_preprocess_matches_jax(mode):
    from tests.conftest import FakeTokenizer

    def sources():
        return [[
            {"from": "human", "value": PROMPTS[mode]},
            {"from": "gpt", "value": "two people and a car"},
            {"from": "human", "value": "And the wall?"},
            {"from": "gpt", "value": "behind them"},
        ]]

    flags = dict(has_image=mode != "text", has_seg=mode in ("seg", "depth_seg"),
                 has_depth=mode == "depth_seg")
    a, b = sources(), sources()
    assert (tpre.relocate_sentinels(a, use_seg=True, use_depth=True)
            == jpre.relocate_sentinels(b, use_seg=True, use_depth=True))
    for version in ("v1", "llava_v1"):
        got = tpre.preprocess(sources(), FakeTokenizer(), version=version, **flags)
        ref = jpre.preprocess(sources(), FakeTokenizer(), version=version, **flags)
        assert got == ref
    if mode == "image":
        plain = [[{"from": "human", "value": PROMPTS[mode]},
                  {"from": "gpt", "value": "a red bus"}]]
        assert (tpre.preprocess(plain, FakeTokenizer(), version="plain")
                == jpre.preprocess([[dict(m) for m in plain[0]]], FakeTokenizer(),
                                   version="plain"))
