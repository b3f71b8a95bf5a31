"""The 13B full-LLM stage's driver on the CPU (f32), at 13B's head layout
(H = KH = 40 heads of 8, hidden 320, intermediate 864, 2 layers, the tiny
tower), from a llava-typed directory written by
``chip_smoke.write_llava_dir`` over ``chip_smoke.make_llava_json``'s
conversations of the repo's photos (one turn).

* The port against JAX: ``train.train --stage full --offload-opt-state
  --device cpu`` (the state in unpinned host memory, streamed through the
  same chunked update as on a card) against the JAX package's
  ``vcoder_tpu.train`` ``run_stage("full")`` (resident): 3 steps, losses and
  grad norms within 1e-5 relative, the trained leaves of ``final/`` within
  1e-4 relative + 5% of the learning rate
  (tests/test_torch_13b_train.py's tolerance), the frozen tower bit-equal
  (to JAX's and to the base), and each package's ``final/`` loading in the
  other.
* The driver under a group: the same stage in four gloo ranks
  (``parallel/launch.spawn``, mesh (1, 4, 1), one row a rank) through
  ``chip_smoke.full_mesh_rank``, the rank body of ``scripts/phase18.py
  --mesh``, against the one-device run at B=4: losses within 1e-5
  relative, every rank reporting the same, ``final/`` within 1e-5, each
  rank's host state its shards' moments (a quarter of every ``fsdp``-split
  leaf, the replicated norms and biases whole), and each rank's
  resident/offloaded A/B bit-equal. The rank body's module imports no JAX;
  neither does this one at its top.
"""

import dataclasses
import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)
STEPS = 3
LR = 2e-5


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


def _narrow(cfg_cls):
    """13B's head layout at a width the CPU runs in milliseconds."""
    base = cfg_cls.tiny("vcoder_ds_llava")
    return dataclasses.replace(base, text=dataclasses.replace(
        base.text, hidden_size=320, intermediate_size=864, num_heads=40, num_kv_heads=40))


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    """A JAX-written narrow DS directory, its llava-typed hard link and a
    one-turn LLaVA JSON; the argv of the full stage over them."""
    import jax

    from vcoder_tpu.checkpoint import save_pretrained as jsave
    from vcoder_tpu.config import VCoderConfig as JConfig
    from vcoder_tpu.models import vcoder as jvcoder
    from vcoder_tpu.simple_tokenizer import SimpleTokenizer as JTokenizer

    chip_smoke = _chip_smoke()
    tmp = tmp_path_factory.mktemp("full13")
    ds_dir, base = str(tmp / "vcoder_ds_llava-narrow"), str(tmp / "llava-narrow")
    jcfg = _narrow(JConfig)
    jsave(ds_dir, jvcoder.init_vcoder_params(jax.random.PRNGKey(0), jcfg), jcfg)
    JTokenizer.build_from_texts([chip_smoke.PROMPT]).save_pretrained(ds_dir)
    chip_smoke.write_llava_dir(base, ds_dir)
    data = str(tmp / "llava.json")
    chip_smoke.make_llava_json(data, turns=1)

    def argv(out, batch):
        return ["--model-path", base, "--data-path", data, "--image-folder", REPO,
                "--output-dir", out, "--learning-rate", str(LR), "--num-train-epochs", "1",
                "--per-device-train-batch-size", str(batch), "--model-max-length", "2048",
                "--max-steps", str(STEPS), "--save-steps", str(STEPS)]

    return dict(base=base, argv=argv, tmp=tmp, chip_smoke=chip_smoke)


@pytest.fixture
def f32(monkeypatch):
    """Both packages' drivers load their base checkpoint in f32."""
    import jax.numpy as jnp

    import vcoder_tpu.builder as jb
    import vcoder_tpu_torch.builder as tb

    monkeypatch.setattr(jb, "load_pretrained_model",
                        functools.partial(jb.load_pretrained_model, dtype=jnp.float32))
    monkeypatch.setattr(tb, "load_pretrained_model",
                        functools.partial(tb.load_pretrained_model, dtype=torch.float32))


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [(r["loss"], r["grad_norm"]) for r in map(json.loads, f)]


def _final(out):
    from vcoder_tpu_torch.checkpoint import read_safetensors

    return {k: t.numpy() for k, t in
            read_safetensors(os.path.join(out, "final", "model.safetensors")).items()}


def test_offloaded_full_stage_matches_jax_at_the_13b_layout(stage, f32):
    import vcoder_tpu.builder as jb
    import vcoder_tpu_torch.builder as tb
    from vcoder_tpu.train import drivers as jdrv
    from vcoder_tpu_torch.train import train as ttrain

    jout, tout = str(stage["tmp"] / "jax"), str(stage["tmp"] / "torch")
    jdrv.run_stage("full", jdrv.build_arg_parser().parse_args(
        stage["argv"](jout, 2) + ["--mesh-data", "1", "--mesh-fsdp", "1", "--mesh-model", "1"]))
    trainer = ttrain.main(stage["argv"](tout, 2) + ["--stage", "full", "--offload-opt-state",
                                                    "--device", "cpu"])
    assert trainer.step_fn.stager is not None and trainer.cfg.text.num_heads == 40
    host = [t for t in trainer.opt_state.values() if t.ndim]
    assert host and all(t.device.type == "cpu" and not t.is_pinned() for t in host)
    got, want = _metrics(tout), _metrics(jout)
    assert len(got) == len(want) == STEPS and np.isfinite(got).all()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)
    tf, jf, base = _final(tout), _final(jout), _final_base(stage["base"])
    assert set(tf) == set(jf) and any(k.startswith("model.vision_tower") for k in jf)
    moved = 0
    for k, w in jf.items():
        if k.startswith("vision_model.") or k.startswith("model.vision_tower"):
            np.testing.assert_array_equal(tf[k], w, err_msg=k)  # the frozen tower
            np.testing.assert_array_equal(tf[k], base[k], err_msg=k)
        else:
            np.testing.assert_allclose(tf[k], w, rtol=1e-4, atol=0.05 * LR, err_msg=k)
            moved += int(not np.array_equal(tf[k], base[k]))
    assert moved > 0
    _, jmodel, *_ = jb.load_pretrained_model(os.path.join(tout, "final"))
    _, tmodel, *_ = tb.load_pretrained_model(os.path.join(jout, "final"), device="cpu")
    assert jmodel.config.model_type == tmodel.config.model_type == "llava"
    assert (jmodel.config.text.num_heads, tmodel.config.text.num_heads) == (40, 40)


def _final_base(base):
    from vcoder_tpu_torch.checkpoint import read_safetensors

    return {k: t.float().numpy() for k, t in
            read_safetensors(os.path.join(base, "model.safetensors")).items()}


def _f32_rank(rank, world, argv):
    """``chip_smoke.full_mesh_rank`` with the base loaded in f32, one thread."""
    import vcoder_tpu_torch.builder as tb

    torch.set_num_threads(1)
    tb.load_pretrained_model = functools.partial(tb.load_pretrained_model, dtype=torch.float32)
    sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke.full_mesh_rank(rank, world, argv, piped=False)


def test_full_stage_under_a_four_rank_group_matches_one_device(stage, monkeypatch):
    import vcoder_tpu_torch.builder as tb
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.parallel import launch
    from vcoder_tpu_torch.train import train as ttrain

    chip_smoke = stage["chip_smoke"]
    monkeypatch.setattr(tb, "load_pretrained_model",
                        functools.partial(tb.load_pretrained_model, dtype=torch.float32))
    flags = ["--stage", "full", "--offload-opt-state", "--device", "cpu"]
    one, mesh_out = str(stage["tmp"] / "one"), str(stage["tmp"] / "mesh")
    ttrain.main(stage["argv"](one, 4) + flags)
    argv = stage["argv"](mesh_out, 1) + flags + ["--mesh-data", "1", "--mesh-fsdp", "4",
                                                  "--mesh-model", "1"]
    monkeypatch.syspath_prepend(REPO)  # the ranks import chip_smoke
    ranks = launch.spawn(_f32_rank, 4, argv, timeout_s=300)
    assert [r["mesh"] for r in ranks] == [dict(data=1, fsdp=4, model=1)] * 4
    same = [[(x["loss"], x["grad_norm"], x["norms"]) for x in r["records"]] for r in ranks]
    assert all(x == same[0] for x in same)  # every rank the same losses and norms
    got = [(r["loss"], r["grad_norm"]) for r in ranks[0]["records"]]
    np.testing.assert_allclose(np.asarray(got), np.asarray(_metrics(one)), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(_metrics(mesh_out)), np.asarray(_metrics(one)),
                               rtol=1e-5)
    assert ranks[0]["final_config"]["model_type"] == "llava"
    a, b = _final(mesh_out), _final(one)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7, err_msg=k)
    # Each rank's host state: its shards' moments, in f32 (the base's dtype).
    with open(os.path.join(stage["base"], "config.json")) as f:
        cfg = VCoderConfig.from_hf_config(json.load(f))
    whole = chip_smoke.full_stage_reckoning(cfg)["moments"]
    per_rank = chip_smoke.full_stage_reckoning(cfg, fsdp=4)["moments"]
    assert whole / 4 <= per_rank < whole / 4 + 0.01 * whole
    for r in ranks:
        assert r["placed"] and r["pinned"] == 2 * per_rank, (r["rank"], r["pinned"])
        assert r["counts"]["flash_bwd"] == 0  # the CPU launches no kernel
        assert r["ab"]["moments"] == 2 * per_rank  # the A/B's gates passed on every rank
