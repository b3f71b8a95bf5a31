"""``chip_smoke.py`` phase 11 (the COST depth eval) on a tiny model, on the CPU.

The card runs the phase on VCoder-DS-7B; here the same functions run on the
tiny DS config in bf16 (``cost_eval_prepare`` on the weights in memory, then
``phase_cost_eval`` on their checkpoint), so the tree, the prompt rows, the
record parsing and the gates are exercised before a card sees them. The CPU
launches no kernel, so the launch counters read what the card's would
(32 flash launches, 23 ViT blocks, no paged launch for one batch of 8); a
wrong count must still fail the phase.
"""

import dataclasses
import os
import sys

import pytest
import torch

pytest.importorskip("PIL")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def phase(tmp_path_factory):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from vcoder_tpu_torch.builder import VCoderForCausalLM
    from vcoder_tpu_torch.checkpoint import save_pretrained
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.models import vcoder as model_mod

    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, eos_token_id=-1))
    params = model_mod.init_vcoder_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    tok = chip_smoke.full_vocab_tokenizer(cfg)
    d = str(tmp_path_factory.mktemp("ck") / chip_smoke.SURFACE_DIR)
    save_pretrained(d, params, cfg)
    tok.save_pretrained(d)
    return chip_smoke, cfg, [params, VCoderForCausalLM(cfg, params)], tok, d


@pytest.mark.parametrize("counts,ok", [
    (dict(flash=32, vit=23, paged=0, k8=0), True),
    (dict(flash=31, vit=23, paged=0, k8=0), False),
    (dict(flash=32, vit=23, paged=32, k8=32), False),
])
def test_phase11_on_a_tiny_model(phase, monkeypatch, capsys, counts, ok):
    chip_smoke, cfg, held, tok, d = phase
    prep = chip_smoke.cost_eval_prepare(cfg, held, tok, device="cpu")
    assert len(prep["rows"]) == 8 and len(prep["firsts"]) == 8
    assert prep["jpeg"]["route"] == "libjpeg"
    monkeypatch.setattr(chip_smoke, "_counters", lambda: dict(counts))
    if not ok:
        with pytest.raises(SystemExit, match="launches"):
            chip_smoke.phase_cost_eval(d, prep, tok, device="cpu")
    else:
        assert chip_smoke.phase_cost_eval(d, prep, tok, device="cpu") == {"flash": 32, "vit": 23}
        out = capsys.readouterr().out
        assert "8 records in the record format" in out and "DS per key" in out
    assert not os.path.exists(prep["tree"]["root"])  # the phase removes its tree
