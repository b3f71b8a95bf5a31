"""``chip_smoke.py`` phase 17 (VCoder-DS-13B training: the VCoder-DS stage
and the VCoder-IT LoRA stage) on a tiny model, on the CPU.

The card runs it in phase 16's 13B directory; here the same functions run in
a tiny DS directory in bf16: ``vcoder_ds_train`` and ``vcoder_it
--lora-enable`` (rank 128, accumulation to 16 rows) through their parsers
and ``run_stage``, the weight files through pipes, the route check on the
trained tree, the LoRA gates on each micro-batch's gradients, the frozen
leaves' digests, the adapters' and ``final/``'s headers and the merge's
readings. The CPU launches no kernel and measures no device memory: the
launch counters are read through a stand-in that gives the card's counts
for the steps that ran (a wrong count must still fail the phase), and the
memory gates are the card's alone.
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
    K1, L K6 and 23 ViT blocks a step or micro-batch); ``wrong`` adds to
    one."""
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


def test_phase17_on_a_tiny_model(tiny, card_counts, capsys):
    chip_smoke, cfg, d = tiny
    L = cfg.text.num_layers
    got = chip_smoke.phase_train_13b(d, device="cpu")
    micro = chip_smoke.IT_LORA_UPDATES * chip_smoke.IT_LORA_ROWS // chip_smoke.IT_LORA_BATCH
    steps = chip_smoke.TRAIN_STEPS_13B + micro
    assert got == dict(flash=2 * L * steps, flash_bwd=L * steps, vit=23 * steps)
    out = capsys.readouterr().out
    assert "17a: kernel vs plain route" in out and "17b: merge" in out
    assert out.count("    step ") == steps and "phase17: {" in out


def test_phase17_fails_a_wrong_count(tiny, card_counts):
    chip_smoke, _, d = tiny
    card_counts["flash_bwd"] = -1  # one K6 launch missing
    with pytest.raises(SystemExit, match="17a: launches"):
        chip_smoke.phase_train_13b(d, device="cpu")


@pytest.mark.parametrize("key,delta,ok", [(None, 0, True), ("flash_bwd", -1, False),
                                          ("flash", -1, False), ("vit", 1, False),
                                          ("mlp", 1, False), ("paged", 40, False),
                                          ("int8_scaled", 1, False)])
def test_per_micro_batch_launch_gate(tiny, key, delta, ok):
    """40 K6, 80 K1 and 23 ViT blocks a micro-batch at 13B, and no other
    kernel: one K6 launch missing or any extra kernel fails the gate."""
    chip_smoke = tiny[0]
    n = 24
    counts = dict(flash=80 * n, flash_bwd=40 * n, vit=23 * n, mlp=0, k8=0, paged=0, int4=0,
                  int8=0, int8_scaled=0)
    if key:
        counts[key] += delta
    if ok:
        chip_smoke.train_launch_gate("17b", counts, 40, n)
    else:
        with pytest.raises(SystemExit, match="17b: launches"):
            chip_smoke.train_launch_gate("17b", counts, 40, n)


def _lora_records(accum, updates, a_from=3):
    norms = []
    for i in range(accum * updates):
        u = i // accum + 1
        n = {f"lm/layers/{p}/{f}": (0.0 if f == "a" and u < a_from else 0.5)
             for p in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                       "down_proj") for f in ("a", "b")}
        n.update({"seg_projector/w/0": 0.1, "mm_projector/w/0": 0.2})
        norms.append(dict(ms=1.0, T=1536, tokens=10, norms=n))
    return norms


@pytest.mark.parametrize("a_from,ok", [(3, True), (2, False), (4, False)])
def test_lora_gradient_gate(tiny, a_from, ok, monkeypatch):
    """a's gradient is 0 through the first two updates and non-zero in the
    third: one that moves early or not at all fails the gate."""
    chip_smoke = tiny[0]
    monkeypatch.setattr(chip_smoke, "_frozen_digest", lambda p, d: "same")
    monkeypatch.setattr(chip_smoke, "_final_gate", lambda *a: [])
    cfg = type("C", (), {"text": tiny[1].text})()
    trainer = type("T", (), {"cfg": cfg, "params": None})()
    accum = 2
    res = dict(trainer=trainer, records=_lora_records(accum, 3, a_from),
               metrics=[dict(loss=1.0, grad_norm=1.0)] * 6,
               piped={"adapters.safetensors": {"header": {}},
                      "final/model.safetensors": {"header": {}}})
    bad = chip_smoke._it_lora_gates(res, accum, tiny[1].text.num_layers, "same", "cpu")
    a_bad = [b for b in bad if "a gradients" in b]
    assert (not a_bad) == ok, bad
    assert any("adapters.safetensors" in b for b in bad)  # the empty header fails too
    assert any("final/ is not a merged" in b for b in bad)


def test_measured_merge_reads_the_merged_bytes(tiny):
    from vcoder_tpu_torch import lora

    chip_smoke = tiny[0]
    params = {"lm": {"layers": {"q_proj": torch.ones(3, 8, 6, dtype=torch.bfloat16),
                                "norm": torch.ones(3, 8)}}}
    wrapped = lora.add_lora(params, torch.Generator().manual_seed(0), rank=4,
                            targets=(r".*q_proj$",))
    got = {}
    with chip_smoke.measured_merge(got, "cpu"):
        merged = lora.merge_lora(wrapped)
    assert lora.merge_lora is not None and got["merged"] == 3 * 8 * 6 * 2
    assert torch.equal(merged["lm"]["layers"]["q_proj"], params["lm"]["layers"]["q_proj"])
    assert np.isnan(got["held"]) and got["over"] == 0
