"""``chip_smoke.py`` phase 18 (the 13B full-LLM stage with the Adam moments
offloaded) on a tiny model, on the CPU, and the memory reckoning its gates
read.

The card runs phase 18 in phase 16's 13B directory; here the same function
runs in a tiny DS directory in bf16: the llava-typed hard link,
``train.train --stage full --offload-opt-state``'s entry point, the weight
files through pipes, the state's bytes against the reckoning and the
host-memory reading. The CPU launches no kernel and measures no device
memory: the launch counters are read through a stand-in that gives the
card's counts for the steps that ran (a wrong count must still fail the
phase), and the device-peak and pinned-holding gates are the card's alone.

The reckoning (``full_stage_reckoning``) is held to the figures measured on
the card at 7B (phase 14: 25.18 GiB of moments, the host allocator
holding 35.52 GB) and gives 13B's: 48.6 GiB of bf16 moments, ~71.0 GB
pinned. The four-card run's gates (``full_mesh_gates``) are held to
readings made up here, one fault at a time.
"""

import copy
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    chip_smoke = _chip_smoke()
    from vcoder_tpu_torch.checkpoint import save_pretrained
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.models import vcoder as model_mod

    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, eos_token_id=-1))
    params = model_mod.init_vcoder_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    d = str(tmp_path_factory.mktemp("ck") / chip_smoke.DIR_13B)
    save_pretrained(d, params, cfg)
    chip_smoke.full_vocab_tokenizer(cfg).save_pretrained(d)
    return chip_smoke, cfg, d


@pytest.fixture
def card_counts(tiny, monkeypatch):
    """The card's launch counts for the steps run since the last reset (2L
    K1, L K6 and 23 ViT blocks a step); ``wrong`` adds to one."""
    from vcoder_tpu_torch.train import trainer as trainer_mod

    chip_smoke, cfg, _ = tiny
    L = cfg.text.num_layers
    steps, wrong = [0], {}
    make = trainer_mod.make_train_step

    def counting_make(*a, **kw):
        inner = make(*a, **kw)

        def step(*args):
            steps[0] += 1
            return inner(*args)

        step.stager = inner.stager
        return step

    def counters():
        n = steps[0]
        c = dict(flash=2 * L * n, flash_bwd=L * n, vit=23 * n, mlp=0, k8=0, paged=0, int4=0,
                 int8=0, int8_scaled=0)
        return {k: v + wrong.get(k, 0) for k, v in c.items()}

    monkeypatch.setattr(trainer_mod, "make_train_step", counting_make)
    monkeypatch.setattr(chip_smoke, "_reset_counters", lambda: steps.__setitem__(0, 0))
    monkeypatch.setattr(chip_smoke, "_counters", counters)
    return wrong


def test_phase18_on_a_tiny_model(tiny, card_counts, capsys):
    """One-turn conversations keep the tiny rows short on the CPU."""
    chip_smoke, cfg, d = tiny
    L, n = cfg.text.num_layers, chip_smoke.FULL_STEPS_13B
    got = chip_smoke.phase_full_13b(d, device="cpu", turns=1)
    assert got["counts"] == dict(flash=2 * L * n, flash_bwd=L * n, vit=23 * n, mlp=0, k8=0,
                                 paged=0, int4=0, int8=0, int8_scaled=0)
    assert got["B"] == chip_smoke.FULL_BATCH_13B and len(got["losses"]) == n
    assert np.isfinite(got["losses"]).all()
    rk = chip_smoke.full_stage_reckoning(
        dataclasses.replace(cfg, model_type="llava", use_seg=False, use_depth=False,
                            use_mm2_proj=False, use_vcoder_lm_emb=False))
    assert got["pinned_gib"] * 2**30 == rk["moments"]  # the state is the reckoned moments
    assert set(got["files_gib"]) == {f"checkpoint-{n}/state.safetensors.tmp",
                                     "adapters.safetensors", "final/model.safetensors"}
    assert got["host"]["used_gib"] < got["host"]["total_gib"]
    out = capsys.readouterr().out
    assert out.count("full stage step") == n and "phase18: {" in out
    assert "(reckoned, not run)" in out and "written through pipes" in out


def test_phase18_fails_a_wrong_count(tiny, card_counts):
    chip_smoke, _, d = tiny
    card_counts["vit"] = 1  # a ViT block too many
    with pytest.raises(SystemExit, match="full stage 18: launches"):
        chip_smoke.phase_full_13b(d, device="cpu", turns=1)


# Measured on the card (NVIDIA H100 80GB HBM3, 700 W) by phase 14 at 7B:
# the offloaded state's bytes and the host allocator's holding.
PR16_MOMENTS_GIB = 25.18
PR16_HOLDING_GB = 35.52


def _llava(size):
    from vcoder_tpu_torch.config import VCoderConfig

    return VCoderConfig.standard("llava", size)


def test_reckoning_at_7b_is_what_the_card_held():
    chip_smoke = _chip_smoke()
    rk = chip_smoke.full_stage_reckoning(_llava("7b"))
    assert round(rk["moments"] / 2**30, 2) == PR16_MOMENTS_GIB
    assert abs(rk["holding"] / 1e9 - PR16_HOLDING_GB) <= 0.01 * PR16_HOLDING_GB
    assert rk["moments"] == 4 * rk["trainable"]  # bf16 mu and nu, not f32
    assert rk["grads"] == 2 * rk["trainable"] and rk["largest"] == 32 * 4096 * 11008 * 2
    # The estimate reproduces phase 14's B=4 peak it was calibrated on.
    est = chip_smoke.full_peak_estimate_gib(rk, 4)
    assert abs(est - chip_smoke.PEAK_SLACK_GIB - 50.56) < 0.05


def test_reckoning_at_13b_gives_phase_18s_figures():
    chip_smoke = _chip_smoke()
    rk = chip_smoke.full_stage_reckoning(_llava("13b"))
    assert round(rk["trainable"] / 1e9, 2) == 13.05
    assert round(rk["moments"] / 2**30, 1) == 48.6
    assert round(rk["holding"] / 1e9, 1) == 71.0
    assert round(rk["weights"] / 2**30, 2) == 24.87 and round(rk["grads"] / 2**30, 2) == 24.30
    # Resident, the weights, gradients and moments alone exceed the card's
    # 79.2 GiB; offloaded, B=2 fits under the estimate and B=4 does not.
    assert rk["resident"] / 2**30 > 95
    card = 79.2
    assert chip_smoke.full_peak_estimate_gib(rk, chip_smoke.FULL_BATCH_13B) < card
    assert chip_smoke.full_peak_estimate_gib(rk, 4) > card


@pytest.mark.parametrize("size", ["7b", "13b"])
def test_reckoning_per_rank_is_a_quarter_of_the_sharded_leaves(size):
    """Over mesh (1, 4, 1) a rank holds a quarter of every leaf the rules
    shard over ``fsdp`` and the replicated ones (norms, projector biases)
    whole."""
    chip_smoke = _chip_smoke()
    import torch as t

    from vcoder_tpu_torch.models.vcoder import build_vcoder_params
    from vcoder_tpu_torch.train.step import trainable_leaves

    cfg = _llava(size)
    whole = chip_smoke.full_stage_reckoning(cfg)
    rank = chip_smoke.full_stage_reckoning(cfg, fsdp=4)
    meta = trainable_leaves(build_vcoder_params(cfg, t.Generator(), dtype=t.bfloat16,
                                                device="meta"), "full")
    repl = 2 * sum(x.numel() * 2 for p, x in meta.items()
                   if chip_smoke._local_shape(p, x.shape, 4) == tuple(x.shape))
    assert repl < 1e-4 * whole["moments"]  # norms and biases only
    assert rank["moments"] == (whole["moments"] - repl) // 4 + repl
    assert rank["holding"] < whole["holding"] / 3


def _mesh_readings(n=4, steps=4, L=40):
    rec = [dict(ms=900.0 + i, T=2048, tokens=7000, loss=7.0 - 0.1 * i, grad_norm=3.0,
                norms={"lm/layers/q_proj": 0.5, "mm_projector/w/0": 0.25}) for i in range(steps)]
    rk = dict(moments=100, weights=1 << 30, grads=1 << 30, largest=1 << 28, layer=1 << 20,
              row=1 << 30)
    host = dict(rss_gib=10.0, rss_grew_gib=0.0, pinned_in_rss=False, used_gib=20.0,
                total_gib=384.0)
    return [dict(rank=r, mesh=dict(data=1, fsdp=4, model=1), layers=L, records=copy.deepcopy(rec),
                 counts=dict(flash=2 * L * steps, flash_bwd=L * steps, vit=0, mlp=0, k8=0,
                             paged=0, int4=0, int8=0, int8_scaled=0),
                 peak=5 * 2**30, pinned=100, placed=True, holding=128, host=dict(host),
                 pin_s=1.0, load_s=1.0, wall=10.0, sizes={},
                 final_config=dict(model_type="llava", num_hidden_layers=L) if r == 0 else None,
                 reckoned=dict(rk), device=f"cuda:{r}",
                 ab=dict(peak_resident=2.0, peak_offloaded=1.0, ms={}, moments=100))
            for r in range(n)]


@pytest.mark.parametrize("fault", [None, "rank", "loss", "norm", "count", "vit", "pinned",
                                   "placed", "peak", "final", "host"])
def test_mesh_gates_catch_each_fault(fault):
    chip_smoke = _chip_smoke()
    ranks = _mesh_readings()
    ref = dict(loss=7.0, grad_norm=3.0, norms={"lm/layers/q_proj": 0.5}, rows=16, T=2048)
    if fault == "rank":
        ranks[2]["records"][3]["loss"] += 1e-6
    elif fault == "loss":
        ref["loss"] *= 1 + 2 * chip_smoke.SHARDED_LOSS_REL
    elif fault == "norm":
        ref["grad_norm"] *= 1 + 2 * chip_smoke.SHARDED_NORM_REL
    elif fault == "count":
        ranks[1]["counts"]["flash_bwd"] -= 1
    elif fault == "vit":
        ranks[3]["counts"]["vit"] = 23 * 4
    elif fault == "pinned":
        ranks[0]["pinned"] = 400  # the whole state, not its shards
    elif fault == "placed":
        ranks[1]["placed"] = False
    elif fault == "peak":
        ranks[2]["peak"] = 200 * 2**30
    elif fault == "final":
        ranks[0]["final_config"]["num_hidden_layers"] = 32
    elif fault == "host":
        for r in ranks:
            r["host"]["used_gib"] = 100.0
    summary, bad = chip_smoke.full_mesh_gates(ranks, ref, 4, 4)
    assert bool(bad) == (fault is not None), bad
    assert summary["losses"] == [7.0, 6.9, 6.8, 6.7] and summary["step1"]["loss_rel"] == (
        0.0 if fault != "loss" else summary["step1"]["loss_rel"])


def test_norms_sum_a_stacked_leaf_a_chunk_at_a_time(monkeypatch):
    """``step.sq_sum`` takes a leaf larger than ``OFFLOAD_CHUNK_BYTES`` in
    axis-0 chunks (no f32 copy of the whole leaf) and gives its sum of
    squares; a leaf of one chunk is summed whole, as before."""
    from vcoder_tpu_torch.train import step

    g = torch.Generator().manual_seed(0)
    t = torch.randn(40, 64, 96, generator=g).bfloat16()
    whole = t.float().square().sum()
    assert torch.equal(step.sq_sum(t), whole)
    monkeypatch.setattr(step, "OFFLOAD_CHUNK_BYTES", 3 * 64 * 96 * 2)
    assert len(step.chunk_rows(t)) == 14
    widths = []
    real = torch.Tensor.float

    def seen(x):
        widths.append(x.shape[0])
        return real(x)

    monkeypatch.setattr(torch.Tensor, "float", seen)
    got = step.sq_sum(t)
    assert max(widths) == 3 and sum(widths) == 40
    torch.testing.assert_close(got, whole, rtol=1e-6, atol=0)
    torch.testing.assert_close(step.global_norm([t, t[:2]]),
                               torch.sqrt(whole + t[:2].float().square().sum()), rtol=1e-6,
                               atol=0)
