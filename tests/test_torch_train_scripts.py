"""The port's training shells (``scripts/v1_5/train_torch/``) on the CPU.

Each of the JAX package's seven training shells has a port twin that runs
``python -m vcoder_tpu_torch.train.<module>`` with ``--device $DEVICE``.
Run by ``bash`` with a stand-in ``python`` that records its arguments,
every shell must name an existing entry point whose parser accepts the
flags it passes, with the environment's paths in place. One shell,
``vcoder_ds_train.sh``, then trains 2 steps for real with ``DEVICE=cpu``
on a tiny base and tests/test_train_pipeline.py's COST tree.
"""

import importlib
import json
import os
import subprocess

import pytest

PIL = pytest.importorskip("PIL.Image")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V15 = os.path.join(REPO, "scripts", "v1_5")
TRAIN = os.path.join(V15, "train_torch")
ENV = dict(MODEL_PATH="/m", OUTPUT_DIR="/o", DATA_PATH="/d.json", IMAGE_FOLDER="/i",
           SEG_DATA_PATH="/s", DEPTH_DATA_PATH="/dd", BATCH_SIZE="3", DEVICE="cpu")


def _recorded_argv(script, tmp_path, env_extra=()):
    """The argv the shell hands ``python``, through a stand-in on PATH."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    fake = bindir / "python"
    fake.write_text('#!/bin/bash\nprintf "%s\\n" "$@" > "$ARGV_OUT"\n')
    fake.chmod(0o755)
    out = tmp_path / f"{script}.argv"
    env = dict(os.environ, PATH=f"{bindir}:{os.environ['PATH']}", ARGV_OUT=str(out), **ENV)
    env.update(env_extra)
    proc = subprocess.run(["bash", os.path.join(TRAIN, script), "--max-steps", "1"], env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    return out.read_text().splitlines()


def test_every_jax_training_shell_has_a_port_shell():
    jax_shells = sorted(n for n in os.listdir(V15) if n.endswith(".sh"))
    assert sorted(os.listdir(TRAIN)) == jax_shells and len(jax_shells) == 7
    for name in jax_shells:
        text = open(os.path.join(TRAIN, name)).read()
        assert "vcoder_tpu.train" not in text and "python -m vcoder_tpu_torch.train." in text
        assert text.count("--device $DEVICE") == 1, name


@pytest.mark.parametrize("script", sorted(
    n for n in os.listdir(os.path.join(V15, "train_torch")) if n.endswith(".sh")))
def test_shell_names_an_entry_point_and_its_flags(script, tmp_path):
    argv = _recorded_argv(script, tmp_path)
    assert argv[0] == "-m" and argv[1].startswith("vcoder_tpu_torch.train.")
    mod = importlib.import_module(argv[1])
    parser = mod.build_parser() if hasattr(mod, "build_parser") else None
    if parser is None:
        from vcoder_tpu_torch.train.drivers import build_arg_parser

        parser = build_arg_parser()
    args = parser.parse_args(argv[2:])
    assert (args.model_path, args.output_dir, args.device) == ("/m", "/o", "cpu")
    assert args.max_steps == 1 and args.per_device_train_batch_size == 3
    if "--seg-data-path" in argv:
        assert args.seg_data_path == "/s"
    if script.endswith("lora.sh"):
        assert args.lora_enable and (args.lora_r, args.lora_alpha) == (128, 256.0)
    assert not args.offload_opt_state
    # The JAX shell passes the same flags, the device aside.
    jargv = open(os.path.join(V15, script)).read()
    for flag in (a for a in argv[2:] if a.startswith("--")):
        assert flag in jargv or flag in ("--device", "--max-steps"), flag


def test_vcoder_ds_train_sh_trains_on_the_cpu(tmp_path):
    import jax

    from tests.test_train_pipeline import KEYS, _make_cost_tree
    from tests.test_train_shell_rehearsal import COMMON_FLAGS
    from vcoder_tpu.checkpoint import save_pretrained
    from vcoder_tpu.config import VCoderConfig
    from vcoder_tpu.models import vcoder as model_mod
    from vcoder_tpu.simple_tokenizer import SimpleTokenizer

    base = str(tmp_path / "llava-tiny")
    cfg = VCoderConfig.tiny("llava")
    save_pretrained(base, model_mod.init_vcoder_params(jax.random.PRNGKey(0), cfg), cfg)
    SimpleTokenizer.build_from_texts(["USER: ASSISTANT: What objects can be seen in the "
                                      "image? two people, a car, wall."]).save_pretrained(base)
    cost = str(tmp_path / "cost")
    _make_cost_tree(cost)
    # All six stage-3 streams: the mix's "coco" entries have COST renders.
    mix = tmp_path / "mix.json"
    mix.write_text(json.dumps([
        {"id": str(i), "image": f"coco/train2017/{k}",
         "conversations": [{"from": "human", "value": "<image>\nWhat objects can be seen?"},
                           {"from": "gpt", "value": "two people, a car"}]}
        for i, k in enumerate(KEYS)]))
    out = tmp_path / "out"
    env = dict(os.environ, PYTHONPATH=REPO, DEVICE="cpu", OMP_NUM_THREADS="1", BATCH_SIZE="2",
               MODEL_PATH=base, OUTPUT_DIR=str(out), SEG_DATA_PATH=cost, DEPTH_DATA_PATH=cost,
               IMAGE_FOLDER=cost, DATA_PATH=str(mix))
    proc = subprocess.run(["bash", os.path.join(TRAIN, "vcoder_ds_train.sh"), *COMMON_FLAGS],
                          env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    with open(out / "metrics.jsonl") as f:
        assert len([json.loads(line) for line in f]) == 2
    assert (out / "checkpoint-2" / "state.safetensors").is_file()
    with open(out / "final" / "config.json") as f:
        assert json.load(f)["model_type"] == "vcoder_ds_llava"
