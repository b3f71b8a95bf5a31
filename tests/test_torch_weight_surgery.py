"""The port's weight surgery against the JAX package's, on the CPU.

Checkpoints are written by the JAX package's ``save_pretrained`` (tiny
configs, f32) or as bare safetensors files. On the same inputs:

* ``make_delta``, ``apply_delta`` and ``consolidate`` write tensors
  byte-equal to JAX's (the embedding-growth rule over both axes included)
  and carry the same config and tokenizer files; a delta round trip restores
  the target;
* ``merge_lora`` of a port ``Trainer``'s ``adapters.safetensors`` (stage
  ``lora``, rank 4) equals JAX's ``merge_lora`` of the same file within f32
  rounding, keeps a bf16 base bf16, refuses a rank other than
  ``--lora-rank``, and the merged checkpoint loads and greedy-decodes as the
  trained model in memory does.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from vcoder_tpu import weight_surgery as jws
from vcoder_tpu.checkpoint import save_pretrained as jsave
from vcoder_tpu.config import VCoderConfig as JConfig
from vcoder_tpu.models import vcoder as jvcoder
from vcoder_tpu.simple_tokenizer import SimpleTokenizer as JTokenizer
from vcoder_tpu_torch import weight_surgery as tws
from vcoder_tpu_torch.checkpoint import load_state, read_safetensors, write_safetensors

torch.set_num_threads(1)


def _ckpt(path, model_type="vcoder_llava", seed=0):
    cfg = JConfig.tiny(model_type)
    jsave(str(path), jvcoder.init_vcoder_params(jax.random.PRNGKey(seed), cfg), cfg)
    JTokenizer.build_from_texts(["USER: ASSISTANT: what objects two people"]).save_pretrained(
        str(path))
    return str(path)


def _assert_same_files(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    sa, sb = load_state(a), load_state(b)
    assert sorted(sa) == sorted(sb)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]), k
    for name in os.listdir(a):
        if not name.endswith(".safetensors"):
            assert open(os.path.join(a, name), "rb").read() == \
                open(os.path.join(b, name), "rb").read(), name


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("surgery")
    return root, _ckpt(root / "base", seed=0), _ckpt(root / "target", seed=1)


def test_delta_roundtrip_matches_jax(pair, tmp_path):
    _, base, target = pair
    for mod, tag in ((jws, "jax"), (tws, "port")):
        mod.make_delta(base, target, str(tmp_path / tag / "delta"))
        mod.apply_delta(base, str(tmp_path / tag / "delta"), str(tmp_path / tag / "restored"))
    _assert_same_files(tmp_path / "jax" / "delta", tmp_path / "port" / "delta")
    _assert_same_files(tmp_path / "jax" / "restored", tmp_path / "port" / "restored")
    want, got = load_state(target), load_state(str(tmp_path / "port" / "restored"))
    assert sorted(want) == sorted(got)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0, msg=k)


def test_consolidate_matches_jax(pair, tmp_path):
    _, base, _ = pair
    jws.consolidate(base, str(tmp_path / "jax"))
    tws.consolidate(base, str(tmp_path / "port"))
    _assert_same_files(tmp_path / "jax", tmp_path / "port")
    assert {"model.safetensors", "config.json", "vcoder_tokenizer.json"} <= set(
        os.listdir(tmp_path / "port"))


def _state_dir(path, state):
    os.makedirs(path)
    write_safetensors(os.path.join(path, "model.safetensors"), state)
    return str(path)


def test_embedding_growth_over_both_axes_matches_jax(tmp_path):
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g)

    base = _state_dir(tmp_path / "base", {"model.embed_tokens.weight": t(10, 4),
                                           "lm_head.weight": t(10, 4), "model.norm.weight": t(4)})
    target = _state_dir(tmp_path / "target", {
        "model.embed_tokens.weight": t(12, 6), "lm_head.weight": t(12, 4),
        "model.norm.weight": t(4), "model.mm_projector.0.weight": t(3, 2)})
    for mod, tag in ((jws, "jax"), (tws, "port")):
        mod.make_delta(base, target, str(tmp_path / tag / "delta"))
        mod.apply_delta(base, str(tmp_path / tag / "delta"), str(tmp_path / tag / "restored"))
    _assert_same_files(tmp_path / "jax" / "delta", tmp_path / "port" / "delta")
    _assert_same_files(tmp_path / "jax" / "restored", tmp_path / "port" / "restored")
    delta, want = load_state(str(tmp_path / "port" / "delta")), load_state(target)
    # Rows and columns past the base stay absolute; the adapter is absolute.
    assert torch.equal(delta["model.embed_tokens.weight"][10:], want["model.embed_tokens.weight"][10:])
    assert torch.equal(delta["model.embed_tokens.weight"][:, 4:],
                       want["model.embed_tokens.weight"][:, 4:])
    assert torch.equal(delta["model.mm_projector.0.weight"], want["model.mm_projector.0.weight"])
    got = load_state(str(tmp_path / "port" / "restored"))
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0, msg=k)
    bad = _state_dir(tmp_path / "bad", {"model.norm.weight": t(5)})
    for mod in (jws, tws):
        with pytest.raises(AssertionError, match="unexpected shape change"):
            mod.make_delta(base, bad, str(tmp_path / "bad_delta"))


@pytest.fixture(scope="module")
def lora_run(tmp_path_factory):
    """A port Trainer's LoRA run (rank 4, alpha 8) over a JAX-written tiny
    DS base: (base dir, adapters file, trained params, config)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import DSSamples
    from vcoder_tpu_torch.checkpoint import load_hf_checkpoint
    from vcoder_tpu_torch.lora import add_lora
    from vcoder_tpu_torch.train.trainer import TrainArgs, Trainer

    root = tmp_path_factory.mktemp("lora")
    base = _ckpt(root / "vcoder_ds_llava-tiny", "vcoder_ds_llava", seed=3)
    cfg, params = load_hf_checkpoint(base, dtype=torch.float32, device="cpu")
    params = add_lora(params, torch.Generator().manual_seed(0), rank=4, alpha=8.0)
    ds = DSSamples(6, cfg.vision.image_size)
    trainer = Trainer(cfg, params, ds, TrainArgs(
        output_dir=str(root / "out"), stage="lora", learning_rate=5e-2,
        per_device_train_batch_size=2, warmup_ratio=0.0, dataloader_workers=0),
        device="cpu")
    trainer.train(max_steps=3)
    return base, trainer.save_adapters(), trainer.params, cfg


def test_merge_lora_matches_jax(lora_run, tmp_path):
    base, adapters, _, _ = lora_run
    flat = read_safetensors(adapters)
    assert "lm/layers/q_proj/a" in flat and "mm_projector/w/0" in flat
    assert flat["lm/layers/q_proj/b"].abs().max() > 0  # trained away from the identity
    jws.merge_lora(base, adapters, str(tmp_path / "jax"), lora_rank=4, lora_alpha=8.0)
    tws.merge_lora(base, adapters, str(tmp_path / "port"), lora_rank=4, lora_alpha=8.0)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(os.listdir(tmp_path / "port"))
    want, got = load_state(str(tmp_path / "jax")), load_state(str(tmp_path / "port"))
    assert sorted(want) == sorted(got)
    moved = 0
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=1e-6, msg=k)
        moved += not torch.equal(got[k], load_state(base).get(k, got[k]))
    assert moved > 0
    for name in ("config.json", "vcoder_tokenizer.json"):
        assert open(tmp_path / "port" / name).read() == open(tmp_path / "jax" / name).read()


def test_merged_checkpoint_decodes_as_the_trained_model(lora_run, tmp_path):
    from vcoder_tpu_torch.builder import VCoderForCausalLM, load_pretrained_model
    from vcoder_tpu_torch.mm_tokens import tokenizer_depth_seg_token

    base, adapters, params, cfg = lora_run
    out = tmp_path / "vcoder_ds_llava-merged"
    tws.merge_lora(base, adapters, str(out), lora_rank=4, lora_alpha=8.0)
    tok, model, proc, _, _, _ = load_pretrained_model(str(out), dtype=torch.float32,
                                                      device="cpu")
    rng = np.random.RandomState(0)
    px = [proc.preprocess(rng.randint(0, 256, (30, 40, 3), np.uint8))["pixel_values"]
          for _ in range(3)]
    ids = tokenizer_depth_seg_token("USER: <depth>\n<seg>\n<image>\nwhat objects ASSISTANT:", tok)
    with torch.no_grad():
        merged = model.generate([ids], *px, max_new_tokens=12).sequences
        trained = VCoderForCausalLM(cfg, params).generate([ids], *px, max_new_tokens=12).sequences
    np.testing.assert_array_equal(merged, trained)


def test_merge_lora_keeps_a_bf16_base_and_checks_the_rank(lora_run, tmp_path, monkeypatch):
    from vcoder_tpu_torch.checkpoint import load_hf_checkpoint, save_pretrained

    base, adapters, _, _ = lora_run
    cfg, params = load_hf_checkpoint(base, dtype=torch.bfloat16, device="cpu")
    save_pretrained(str(tmp_path / "bf16"), params, cfg)
    monkeypatch.setattr(sys, "argv", ["weight_surgery", "merge-lora", "--base",
                                      str(tmp_path / "bf16"), "--adapters", adapters,
                                      "--target", str(tmp_path / "merged"), "--lora-rank", "4",
                                      "--lora-alpha", "8"])
    tws.main()
    merged = load_state(str(tmp_path / "merged"))
    assert merged["model.layers.0.self_attn.q_proj.weight"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="has rank 4 but --lora-rank is 128"):
        tws.merge_lora(base, adapters, str(tmp_path / "x"))
