"""Shell rehearsal of the port's eval scripts (``scripts/v1_5/eval_torch/``)
on the CPU (``DEVICE=cpu``), as ``tests/test_eval_shell_rehearsal.py`` does
for the JAX package's: tiny checkpoints and synthetic data trees, run by
``bash`` as a user would. What they prove is the plumbing (environment
variables, loader flags, the file contracts between loader, converter and
scorer), not the answers, which come from random weights.
"""

import json
import os
import subprocess

import numpy as np
import pytest

PIL = pytest.importorskip("PIL.Image")

from tests.test_eval_shell_rehearsal import _questions_jsonl, _write_images  # noqa: E402
from tests.test_torch_chat_server import make_tiny_checkpoint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL = os.path.join(REPO, "scripts", "v1_5", "eval_torch")


@pytest.fixture(scope="module")
def ds_ckpt(tmp_path_factory):
    path, _, _ = make_tiny_checkpoint(tmp_path_factory.mktemp("ck") / "vcoder_ds_llava-tiny")
    return path


def _run(script, env_extra, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, DEVICE="cpu", OMP_NUM_THREADS="1")
    env.update(env_extra)
    proc = subprocess.run(["bash", os.path.join(EVAL, script)], env=env, capture_output=True,
                          text=True, timeout=timeout, cwd=REPO)
    assert proc.returncode == 0, (f"{script} rc={proc.returncode}\n" + proc.stdout[-2000:]
                                  + proc.stderr[-3000:])
    return proc


def test_every_jax_script_has_a_port_script():
    jax_dir = os.path.join(REPO, "scripts", "v1_5", "eval")
    assert sorted(os.listdir(EVAL)) == sorted(os.listdir(jax_dir))
    for name in os.listdir(EVAL):
        text = open(os.path.join(EVAL, name)).read()
        assert "vcoder_tpu.eval" not in text and "python -m vcoder_tpu_torch.eval." in text
        assert text.count("--device $DEVICE") == 1, name


def test_cost_depth_sh(ds_ckpt, tmp_path):
    data = tmp_path / "cost"
    keys = [f"{i:012d}.jpg" for i in range(2)]
    _write_images(str(data / "coco" / "val2017"), keys)
    _write_images(str(data / "coco_segm_text" / "val" / "panoptic_inference"), keys)
    depth = data / "coco_segm_text" / "depth" / "val"
    _write_images(str(depth / "depth"), keys)
    (depth / "panoptic_order.txt").write_text("".join(
        f"<IMG>{k}<IMG>The depth order for the objects present in the image is: person, car\n"
        for k in keys))
    out = tmp_path / "out"
    proc = _run("cost_depth.sh", {"CKPT": ds_ckpt, "DATA": str(data), "OUT": str(out)})
    assert "Average depth score is:" in proc.stdout
    text = (out / "output_depth.txt").read_text()
    assert text.count("-" * 55) == 2 and "Image: 000000000001.jpg" in text


def test_cost_sh_two_chunks(ds_ckpt, tmp_path):
    data = tmp_path / "cost"
    keys = [f"{i:012d}.jpg" for i in range(2)]
    _write_images(str(data / "coco" / "val2017"), keys)
    for task in ("semantic", "instance", "panoptic"):
        seg = data / "coco_segm_text" / "val"
        _write_images(str(seg / f"{task}_inference"), keys)
        (seg / f"{task}.txt").write_text("".join(
            f"<IMG>{k}<IMG>The objects present in the image are: two people, a car\n"
            for k in keys))
    out = tmp_path / "out"
    proc = _run("cost.sh", {"CKPT": ds_ckpt, "DATA": str(data), "OUT": str(out), "CHUNKS": "2"})
    assert proc.stdout.count("Average accuracy for") == 3
    for task in ("semantic", "instance", "panoptic"):
        assert (out / f"output_{task}.txt").read_text().count("-" * 55) == 2


def test_pope_sh(ds_ckpt, tmp_path):
    d = tmp_path / "pope"
    names = [f"q{i}.jpg" for i in range(2)]
    _write_images(str(d / "val2014"), names)
    _questions_jsonl(str(d / "llava_pope_test.jsonl"), names, category="random")
    os.makedirs(d / "coco")
    (d / "coco" / "coco_pope_random.json").write_text("".join(
        json.dumps({"question_id": i, "label": "no"}) + "\n" for i in range(2)))
    proc = _run("pope.sh", {"CKPT": ds_ckpt, "D": str(d)})
    assert "Category: random" in proc.stdout and "F1 score:" in proc.stdout


def test_mme_sh(ds_ckpt, tmp_path):
    d = tmp_path / "mme"
    bench = d / "MME_Benchmark_release_version"
    q_text = "Is the sky blue? Please answer yes or no."
    names = ["existence/A.jpg", "existence/B.jpg"]
    _write_images(str(bench), names)
    _questions_jsonl(str(d / "llava_mme.jsonl"), names, text=q_text, category="existence")
    gt_dir = bench / "existence" / "questions_answers_YN"
    os.makedirs(gt_dir)
    for stem in ("A", "B"):
        (gt_dir / f"{stem}.txt").write_text(f"{q_text}\tYes\n")
    proc = _run("mme.sh", {"CKPT": ds_ckpt, "D": str(d)})
    assert "existence: score" in proc.stdout and "perception total:" in proc.stdout


def test_vqav2_sh(ds_ckpt, tmp_path):
    d = tmp_path / "vqav2"
    split = "llava_vqav2_mscoco_test-dev2015"
    names = [f"t{i}.jpg" for i in range(2)]
    _write_images(str(d / "test2015"), names)
    _questions_jsonl(str(d / f"{split}.jsonl"), names)
    _questions_jsonl(str(d / "llava_vqav2_mscoco_test2015.jsonl"), names + ["extra.jpg"])
    _run("vqav2.sh", {"CKPT": ds_ckpt, "D": str(d), "SPLIT": split})
    upload = json.load(open(d / "answers_upload" / split / f"{os.path.basename(ds_ckpt)}.json"))
    assert len(upload) == 3 and upload[2]["answer"] == ""
    assert np.all([isinstance(u["answer"], str) for u in upload])
