"""``chip_smoke.py`` phases 12 (the slot engine) and 13 (a training stage from
files) on a tiny model, on the CPU.

The card runs them on VCoder-DS-7B; here the same functions run on the tiny
DS config in bf16, so the traffic, the engines, the replay of every token
on ``generate``'s decode path, the prefill-logit bound, the COST training
tree, ``vcoder_ds_train``'s entry point and the output checks are exercised
before a card sees them. The CPU launches no kernel: phase 12's launch gate
is held to the card's counts on its own, and phase 13 reads the card's
counts through a stand-in (a wrong count must still fail it).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from vcoder_tpu_torch.builder import VCoderForCausalLM
    from vcoder_tpu_torch.checkpoint import save_pretrained
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.mm_tokens import tokenizer_depth_seg_token
    from vcoder_tpu_torch.models import vcoder as model_mod
    from vcoder_tpu_torch.serve.chat import PreparedRequest

    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, eos_token_id=-1))
    params = model_mod.init_vcoder_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    tok = chip_smoke.full_vocab_tokenizer(cfg)
    ids = tokenizer_depth_seg_token(chip_smoke.PROMPT, tok)
    rng = np.random.RandomState(11)
    hw = cfg.vision.image_size
    preps = [PreparedRequest(ori_prompt=chip_smoke.PROMPT, input_ids=list(ids),
                             images=rng.randn(1, hw, hw, 3).astype(np.float32),
                             segs=rng.randn(1, hw, hw, 3).astype(np.float32),
                             depths=rng.randn(1, hw, hw, 3).astype(np.float32),
                             max_new_tokens=32, temperature=0.0, top_p=1.0, stop_str=None)
             for _ in range(8)]
    d = str(tmp_path_factory.mktemp("ck") / chip_smoke.SURFACE_DIR)
    save_pretrained(d, params, cfg)
    tok.save_pretrained(d)
    return chip_smoke, cfg, params, VCoderForCausalLM(cfg, params), preps, d


def test_phase12_on_a_tiny_model(tiny, monkeypatch, capsys):
    chip_smoke, cfg, params, model, preps, _ = tiny
    gated = []
    monkeypatch.setattr(chip_smoke, "_slot_gate", lambda *a: gated.append(a[:1] + a[2:]))
    totals = chip_smoke.phase_slot_engine(cfg, params, model, preps, device="cpu")
    assert totals == {"flash": 0, "vit": 0, "int8_scaled": 0}  # the CPU launches no kernel
    assert [(label[:2], n, q) for label, n, q in gated] == [
        ("S1", 8, False), ("S2", 8, False), ("S3", 8, False), ("S4", 8, True)]
    out = capsys.readouterr().out
    assert "every S1 token replayed" in out and "-> ok" in out and "S4 vs S2" in out


@pytest.mark.parametrize("quantized", [False, True])
def test_phase12_launch_gate(tiny, quantized):
    chip_smoke = tiny[0]
    card = dict(flash=256, flash_bwd=0, vit=0 if quantized else 184, mlp=0, k8=0, paged=0,
                int4=0, int8=0, int8_scaled=2896 if quantized else 0)
    chip_smoke._slot_gate("S", dict(card), 8, quantized)
    for key, wrong in (("flash", 255), ("paged", 32), ("vit", 23 if quantized else 0),
                       ("int8_scaled", 0 if quantized else 362)):
        with pytest.raises(SystemExit, match="launches"):
            chip_smoke._slot_gate("S", dict(card, **{key: wrong}), 8, quantized)


@pytest.mark.parametrize("counts,ok", [
    (dict(flash=256, flash_bwd=128, vit=92, mlp=0, k8=0, paged=0, int4=0, int8=0,
          int8_scaled=0), True),
    (dict(flash=256, flash_bwd=127, vit=92, mlp=0, k8=0, paged=0, int4=0, int8=0,
          int8_scaled=0), False),
    (dict(flash=256, flash_bwd=128, vit=92, mlp=0, k8=32, paged=32, int4=0, int8=0,
          int8_scaled=0), False),
])
def test_phase13_on_a_tiny_model(tiny, monkeypatch, capsys, counts, ok):
    chip_smoke, *_, d = tiny
    monkeypatch.setattr(chip_smoke, "_counters", lambda: dict(counts))
    if not ok:
        with pytest.raises(SystemExit, match="launches"):
            chip_smoke.phase_train_stage(d, device="cpu")
        return
    got = chip_smoke.phase_train_stage(d, device="cpu")
    assert (got["flash"], got["flash_bwd"], got["vit"]) == (256, 128, 92)
    out = capsys.readouterr().out
    assert "72 entries from the COST tree" in out and "model_type vcoder_ds_llava" in out


def test_train_tree_layout(tiny, tmp_path):
    """The tree has COST's training layout in every bucket, and the port's
    stream builders read it (the JAX package's read it alike)."""
    from vcoder_tpu.train import datasets as jds
    from vcoder_tpu_torch.train import datasets as tds

    chip_smoke = tiny[0]
    root = str(tmp_path / "cost")
    chip_smoke.make_train_tree(root)
    for bucket in chip_smoke.TRAIN_BUCKETS:
        for sub in (f"coco/{bucket}2017", f"coco_segm_text/{bucket}/panoptic_inference",
                    f"coco_segm_text/{bucket}/semantic_inference",
                    f"coco_segm_text/depth/{bucket}/depth"):
            assert sorted(os.listdir(os.path.join(root, sub))) == chip_smoke.COST_KEYS
    got = tds.get_depth_data_split(root, seed=4)
    assert got == jds.get_depth_data_split(root, seed=4) and len(got) == 24
    assert tds.build_seg_cost_entries(root, seed=2, with_depth=True) == \
        jds.build_seg_cost_entries(root, seed=2, with_depth=True)
