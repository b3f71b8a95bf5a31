"""``chip_smoke.py`` phase 14 (the full-LLM stage with the Adam moments
offloaded) on a tiny model, on the CPU.

The card runs it on the llava leaves of VCoder-DS-7B; here the same
functions run on the llava leaves of the tiny DS config in bf16: the
plain-LLaVA directory written beside the DS one, the LLaVA-format JSON of
the repo's photos, ``train.train --stage full --offload-opt-state``'s entry
point, the output checks and the resident/offloaded A/B with its bit-equal
digests. The CPU launches no kernel and measures no device memory: the
launch counters are read through a stand-in that gives the card's counts
for the steps that ran (a wrong count must still fail the phase), and the
memory gate is the card's alone.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.models import vcoder as model_mod

    cfg = VCoderConfig.tiny("vcoder_ds_llava")
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, eos_token_id=-1))
    params = model_mod.init_vcoder_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    return chip_smoke, cfg, params, chip_smoke.full_vocab_tokenizer(cfg)


@pytest.fixture
def card_counts(tiny, monkeypatch):
    """The card's launch counts for the steps run since the last reset
    (2L K1, L K6 and 23 ViT blocks a step: 64, 32 and 23 at 7B); ``wrong``
    adds to one."""
    from vcoder_tpu_torch.train import trainer as trainer_mod

    chip_smoke, cfg = tiny[:2]
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


def _ds_dir(tiny, tmp_path):
    """Phase 10's directory: the DS weights and the tokenizer."""
    from vcoder_tpu_torch.checkpoint import save_pretrained

    chip_smoke, cfg, params, tok = tiny
    d = str(tmp_path / chip_smoke.SURFACE_DIR)
    save_pretrained(d, params, cfg)
    tok.save_pretrained(d)
    return d


def test_llava_dir_holds_the_llava_leaves(tiny, tmp_path):
    from vcoder_tpu_torch.builder import load_pretrained_model
    from vcoder_tpu_torch.tree import named_leaves

    chip_smoke, _, params, _ = tiny
    ds = _ds_dir(tiny, tmp_path)
    d = str(tmp_path / chip_smoke.LLAVA_DIR)
    chip_smoke.write_llava_dir(d, ds)
    assert os.path.samefile(os.path.join(d, "model.safetensors"),
                            os.path.join(ds, "model.safetensors"))  # no weight byte written
    assert sorted(os.listdir(d)) == sorted(os.listdir(ds))
    with open(os.path.join(d, "config.json")) as f:
        assert json.load(f)["model_type"] == "llava"
    tok, model, *_ = load_pretrained_model(d, device="cpu")
    assert model.config.model_type == "llava" and not model.config.use_seg
    want = dict(named_leaves({k: params[k] for k in ("vision_tower", "mm_projector", "lm")}))
    got = dict(named_leaves(model.params))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert tok.encode(chip_smoke.PROMPT) == tiny[3].encode(chip_smoke.PROMPT)


def test_llava_json_fills_the_2048_bucket(tiny, tmp_path):
    from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer
    from vcoder_tpu_torch.train import preprocess

    chip_smoke, cfg, _, tok = tiny
    tok.save_pretrained(str(tmp_path / "tok"))
    tok = SimpleTokenizer.from_pretrained(str(tmp_path / "tok"))  # frozen, as the stage loads it
    path = str(tmp_path / "llava.json")
    chip_smoke.make_llava_json(path)
    with open(path) as f:
        entries = json.load(f)
    assert len(entries) == chip_smoke.LLAVA_SAMPLES
    assert all(os.path.isfile(os.path.join(REPO, e["image"])) for e in entries)
    ids = [preprocess.preprocess([e["conversations"]], tok, has_image=True,
                                 version="v1")["input_ids"][0] for e in entries]
    lengths = [len(i) + 576 - 1 for i in ids]  # the image sentinel becomes 576 patches
    assert 1536 < min(lengths) and max(lengths) <= 2048
    assert max(max(i) for i in ids) < cfg.text.vocab_size


def test_phase14_on_a_tiny_model(tiny, tmp_path, card_counts, capsys):
    """One-turn conversations keep the tiny rows short on the CPU."""
    chip_smoke, cfg = tiny[:2]
    L = cfg.text.num_layers
    got = chip_smoke.phase_full_stage(_ds_dir(tiny, tmp_path), device="cpu", turns=1)
    steps = chip_smoke.FULL_STEPS + 2 * chip_smoke.AB_STEPS
    assert (got["flash"], got["flash_bwd"], got["vit"]) == (2 * L * steps, L * steps, 23 * steps)
    out = capsys.readouterr().out
    assert "A/B: leaves and state bit-equal" in out and "model_type llava" in out
    assert out.count("full stage step") == chip_smoke.FULL_STEPS
    assert "written through pipes" in out


def test_piped_weights_check_what_arrives(tiny, tmp_path):
    """The pipes take a stage's writes and renames as files would; the gate
    fails a file that never arrived, a short one and one missing a
    tensor, and a pipe no writer opened does not hang the exit."""
    from vcoder_tpu_torch.checkpoint import write_safetensors

    from vcoder_tpu_torch.train.trainer import Trainer

    chip_smoke = tiny[0]
    out = str(tmp_path / "out")
    st = {"a": torch.ones(3, 4), "b": torch.zeros(5, dtype=torch.bfloat16)}
    with chip_smoke.piped_weights(out, 2) as piped:
        assert not os.path.exists(out)  # no pipe before a trainer has looked for a checkpoint
        stub = type("Stub", (), {"_checkpoints": lambda self: []})()
        assert Trainer.maybe_resume(stub) is False
        tmp = os.path.join(out, "checkpoint-2", "state.safetensors.tmp")
        write_safetensors(tmp, st)
        os.replace(tmp, tmp[:-4])
        write_safetensors(os.path.join(out, "adapters.safetensors"), {"a": st["a"]})
    keys = {"checkpoint-2/state.safetensors.tmp": {"a", "b"}, "adapters.safetensors": {"a"}}
    sizes = chip_smoke.piped_gate("t", piped, keys)
    assert set(sizes) == set(keys)
    with pytest.raises(SystemExit, match="no safetensors header"):
        chip_smoke.piped_gate("t", piped, {"final/model.safetensors": set()})
    with pytest.raises(SystemExit, match="missing"):
        chip_smoke.piped_gate("t", piped, {"adapters.safetensors": {"a", "b"}})
    short = {k: dict(v, bytes=v["bytes"] - 1) for k, v in piped.items()}
    with pytest.raises(SystemExit, match="bytes"):
        chip_smoke.piped_gate("t", short, keys)


def _records(n, lm=0.5, mm=0.25):
    return [dict(ms=1.0, T=2048, tokens=10, norms={"lm/layers/q_proj": lm,
                                                   "lm/embed_tokens": 0.0,
                                                   "mm_projector/w/0": mm}) for _ in range(n)]


def test_phase14_step_gate(tiny):
    chip_smoke = tiny[0]
    card = dict(flash=256, flash_bwd=128, vit=92, mlp=0, k8=0, paged=0, int4=0, int8=0,
                int8_scaled=0)
    chip_smoke._train_gate("CLI", _records(4), dict(card), 4)
    for key, wrong in (("flash", 255), ("flash_bwd", 96), ("vit", 93), ("paged", 32),
                       ("mlp", 23)):
        with pytest.raises(SystemExit, match="launches"):
            chip_smoke._train_gate("CLI", _records(4), dict(card, **{key: wrong}), 4)
    for recs in (_records(4, lm=0.0), _records(4, mm=0.0), _records(3)):
        with pytest.raises(SystemExit, match="full stage CLI"):
            chip_smoke._train_gate("CLI", recs, dict(card), 4)


def test_bits_digest_sees_one_bit():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    g = torch.Generator().manual_seed(0)
    a = {"w": torch.randn(1000, generator=g).bfloat16(), "n": torch.tensor(3, dtype=torch.int32),
         "f": torch.randn(7, 3, generator=g)}
    d = chip_smoke.bits_digest(a, "cpu")
    assert d == chip_smoke.bits_digest({k: v.clone() for k, v in a.items()}, "cpu")
    for k in a:
        b = {n: v.clone() for n, v in a.items()}
        flat = b[k].reshape(-1).view(torch.int16 if b[k].element_size() == 2 else torch.int32)
        flat[-1] ^= 1
        assert chip_smoke.bits_digest(b, "cpu") != d, k
    swapped = dict(a, w=torch.flip(a["w"], [0]))
    assert chip_smoke.bits_digest(swapped, "cpu") != d
    assert np.isfinite(chip_smoke._rss_gib())
