"""The port's stage drivers (``train/drivers.py`` and the ``train.*`` entry
points) against the JAX package's ``run_stage`` (CPU, f32).

Every stage (``vcoder``, ``vcoder_ds`` with the LLaVA-mix streams, ``it``,
``it --lora-enable``, ``pretrain`` and ``full``) trains 2 steps from a tiny
base checkpoint of the stage's own model type, written by the JAX package
(so no adapter branch is drawn from either package's RNG:
``initialize_missing_modules`` draws other numbers in each), over
tests/test_train_pipeline.py's COST tree. Both packages load the base in
f32; the first step's loss must equal JAX's (``--mesh-data 1 --mesh-fsdp 1
--mesh-model 1``) within 2e-5 relative (two f32 implementations; the LoRA
stage's B matrices start at zero, so its other A draws do not move the
first loss). ``final/`` and ``adapters.safetensors`` must load in both
packages; outside torchrun a mesh product above 1 raises a ``ValueError``
naming torchrun, with or without ``--offload-opt-state`` (the offload on
one device is ``test_torch_offload.py``'s; the stage under a process group
``test_torch_sharded_train.py``'s).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

PIL = pytest.importorskip("PIL.Image")

from tests.test_train_pipeline import KEYS, _make_cost_tree  # noqa: E402
from vcoder_tpu.checkpoint import save_pretrained as jsave  # noqa: E402
from vcoder_tpu.config import VCoderConfig as JConfig  # noqa: E402
from vcoder_tpu.models import vcoder as jvcoder  # noqa: E402
from vcoder_tpu.simple_tokenizer import SimpleTokenizer as JTokenizer  # noqa: E402
from vcoder_tpu.train import drivers as jdrv  # noqa: E402
from vcoder_tpu_torch.checkpoint import read_safetensors  # noqa: E402
from vcoder_tpu_torch.train import drivers as tdrv  # noqa: E402
from vcoder_tpu_torch.train import train as ttrain  # noqa: E402

torch.set_num_threads(1)

TEXT = ("A chat between a curious human and an artificial intelligence assistant. The "
        "assistant gives helpful, detailed, and polite answers to the human's questions. "
        "USER: ASSISTANT: What objects can be seen in the image? The objects present in the "
        "image are: two people, a car, wall. What is the depth order for the objects present "
        "in the image? person, car, wall. How many people are there?")
FLAGS = ["--max-steps", "2", "--model-max-length", "192", "--save-steps", "2",
         "--num-train-epochs", "8", "--per-device-train-batch-size", "2"]
# stage, base model type, extra flags (MIX: the LLaVA-mix json and its folder).
CASES = [
    ("vcoder", "vcoder_llava", []),
    ("vcoder_ds", "vcoder_ds_llava", ["MIX"]),
    ("it", "vcoder_it_llava", []),
    ("it", "vcoder_it_llava", ["--lora-enable", "--lora-r", "4", "--lora-alpha", "8"]),
    ("pretrain", "llava", ["MIX"]),
    ("full", "llava", ["MIX"]),
]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cost"))
    _make_cost_tree(root)
    mix = [{"id": str(i), "image": f"coco/train2017/{k}",
            "conversations": [{"from": "human", "value": "<image>\nWhat objects can be seen "
                                                          "in the image?"},
                              {"from": "gpt", "value": "two people, a car"}]}
           for i, k in enumerate(KEYS)]
    mix.append({"id": "text", "conversations": [
        {"from": "human", "value": "How many people are there?"},
        {"from": "gpt", "value": "two people"}]})
    path = os.path.join(root, "mix.json")
    with open(path, "w") as f:
        json.dump(mix, f)
    bases = {}
    for mt in ("llava", "vcoder_llava", "vcoder_ds_llava", "vcoder_it_llava"):
        d = str(tmp_path_factory.mktemp("base") / f"{mt}-tiny")
        cfg = JConfig.tiny(mt)
        jsave(d, jvcoder.init_vcoder_params(jax.random.PRNGKey(0), cfg), cfg)
        JTokenizer.build_from_texts([TEXT]).save_pretrained(d)
        bases[mt] = d
    return dict(root=root, mix=path, bases=bases)


@pytest.fixture
def f32(monkeypatch):
    """Both packages' drivers load their base checkpoint in f32."""
    import vcoder_tpu.builder as jb
    import vcoder_tpu_torch.builder as tb

    monkeypatch.setattr(jb, "load_pretrained_model",
                        functools.partial(jb.load_pretrained_model, dtype=jnp.float32))
    monkeypatch.setattr(tb, "load_pretrained_model",
                        functools.partial(tb.load_pretrained_model, dtype=torch.float32))


def _argv(data, base_type, extra, out):
    argv = ["--model-path", data["bases"][base_type], "--output-dir", out,
            "--seg-data-path", data["root"], "--depth-data-path", data["root"],
            "--image-folder", data["root"]] + FLAGS
    for x in extra:
        argv += ["--data-path", data["mix"]] if x == "MIX" else [x]
    return argv


def _losses(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line)["loss"] for line in f]


def _run_jax(stage, argv):
    args = jdrv.build_arg_parser().parse_args(
        argv + ["--mesh-data", "1", "--mesh-fsdp", "1", "--mesh-model", "1"])
    if stage == "pretrain":
        args.version = "plain"  # vcoder_tpu/train/train.py's rule
    jdrv.run_stage(stage, args)


def _run_torch(stage, argv):
    if stage in ("pretrain", "full"):
        return ttrain.main(argv + ["--stage", stage, "--device", "cpu"])
    return tdrv.run_stage(stage, tdrv.build_arg_parser().parse_args(argv + ["--device", "cpu"]))


@pytest.mark.parametrize("stage,base,extra", CASES,
                         ids=["vcoder", "vcoder_ds", "it", "it_lora", "pretrain", "full"])
def test_stage_matches_jax(data, f32, tmp_path, stage, base, extra):
    import vcoder_tpu.builder as jb
    import vcoder_tpu_torch.builder as tb

    jout, tout = str(tmp_path / "jax"), str(tmp_path / "torch")
    _run_jax(stage, _argv(data, base, extra, jout))
    trainer = _run_torch(stage, _argv(data, base, extra, tout))
    lj, lt = _losses(jout), _losses(tout)
    assert len(lt) == len(lj) == 2 and np.isfinite(lt).all()
    assert abs(lt[0] - lj[0]) <= 2e-5 * abs(lj[0]), (lt, lj)
    want_stage = {"full": "lora", "it": "it_lora"}[stage] if extra[:1] == ["--lora-enable"] \
        else stage
    assert trainer.args.stage == want_stage and trainer.step == 2
    for d in (jout, tout):
        assert os.path.isfile(os.path.join(d, "adapters.safetensors"))
        assert sorted(os.listdir(os.path.join(d, "final"))) == [
            "config.json", "model.safetensors", "vcoder_tokenizer.json"]
    assert os.path.isfile(os.path.join(tout, "checkpoint-2", "state.safetensors"))
    # The outputs load in both packages: the port's final/ through JAX's
    # loader equals the port's own reading of it, and JAX's final/ and
    # adapters load in the port.
    tok, model, *_ = tb.load_pretrained_model(os.path.join(tout, "final"), device="cpu")
    _, jmodel, *_ = jb.load_pretrained_model(os.path.join(tout, "final"))
    assert model.config.model_type == jmodel.config.model_type == trainer.cfg.model_type
    np.testing.assert_array_equal(np.asarray(jmodel.params["lm"]["embed_tokens"]),
                                  model.params["lm"]["embed_tokens"].numpy())
    _, jfinal, *_ = tb.load_pretrained_model(os.path.join(jout, "final"), device="cpu")
    assert jfinal.config == model.config
    assert set(read_safetensors(os.path.join(jout, "adapters.safetensors"))) == set(
        read_safetensors(os.path.join(tout, "adapters.safetensors")))


def test_resume_continues_from_the_step_checkpoint(data, f32, tmp_path, capsys):
    out = str(tmp_path / "out")
    argv = _argv(data, "vcoder_ds_llava", [], out)
    tdrv.run_stage("vcoder_ds", tdrv.build_arg_parser().parse_args(argv + ["--device", "cpu"]))
    argv[argv.index("--max-steps") + 1] = "3"
    trainer = tdrv.run_stage("vcoder_ds",
                             tdrv.build_arg_parser().parse_args(argv + ["--device", "cpu"]))
    assert "Resumed from step 2" in capsys.readouterr().out
    assert trainer.step == 3 and len(_losses(out)) == 3


@pytest.mark.parametrize("flags", [["--offload-opt-state", "--mesh-fsdp", "2"],
                                   ["--mesh-data", "2"],
                                   ["--mesh-fsdp", "2", "--mesh-model", "1"],
                                   ["--mesh-model", "4"]])
def test_multi_device_flags_raise(data, tmp_path, flags):
    """Outside torchrun a mesh product above 1 raises, naming torchrun (the
    stage under a process group: ``test_torch_sharded_train.py``)."""
    argv = _argv(data, "vcoder_ds_llava", [], str(tmp_path / "out")) + flags
    with pytest.raises(ValueError, match="one process per device.*torch.distributed.run"):
        tdrv.run_stage("vcoder_ds", tdrv.build_arg_parser().parse_args(argv))
    assert not os.path.exists(tmp_path / "out")


def test_stage_flags_match_jax():
    """The port's parser takes the JAX parser's flags with their defaults,
    plus ``--device`` (CUDA unless ``cpu``)."""
    j = {a.dest: a.default for a in jdrv.build_arg_parser()._actions}
    t = {a.dest: a.default for a in tdrv.build_arg_parser()._actions}
    assert t.pop("device") == "cuda"
    assert t == j
    assert {a.dest for a in ttrain.build_parser()._actions} - set(t) == {"stage", "device"}
