"""The port's eval loaders against the JAX package's on one tiny checkpoint.

The checkpoint is ``test_torch_chat_server.make_tiny_checkpoint``'s: a
``vcoder_ds_llava-tiny`` directory written by the JAX package, loaded by both
packages in f32 (each loader's ``load_pretrained_model`` wrapped to pass
``dtype=float32``; the port's on ``--device cpu``). On the same synthetic
COST and VQA trees:

* ``cost_loader`` writes the same answers file as JAX's (seg at batch 2;
  seg + depth with ``--tasks depth``; the paragraph-suffix route without
  seg), and ``--lookahead 8`` writes the same file as plain decoding;
* ``--use-depth`` without ``--use-seg`` raises ``SystemExit`` in both;
* ``vqa_loader`` writes the same JSONL records (``answer_id`` aside);
* ``mmbench_loader`` writes JAX's records (``answer_id`` aside) for a TSV
  with base64 JPEG and PNG images and all rounds, and without pandas raises
  an ``ImportError`` that names it.

The answers are random words; what is compared is every byte of the files.
"""

import base64
import builtins
import contextlib
import functools
import io
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_chat_server import make_tiny_checkpoint

PIL = pytest.importorskip("PIL.Image")

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path, _, _ = make_tiny_checkpoint(tmp_path_factory.mktemp("ck") / "vcoder_ds_llava-tiny")
    return path


@contextlib.contextmanager
def f32_loaders():
    import vcoder_tpu.builder as jb
    import vcoder_tpu.eval.cost_loader as jc
    import vcoder_tpu.eval.mmbench_loader as jm
    import vcoder_tpu.eval.vqa_loader as jv
    import vcoder_tpu_torch.builder as tb
    import vcoder_tpu_torch.eval.cost_loader as tc
    import vcoder_tpu_torch.eval.mmbench_loader as tm
    import vcoder_tpu_torch.eval.vqa_loader as tv

    with pytest.MonkeyPatch.context() as mp:
        for mod in (jc, jv, jm):
            mp.setattr(mod, "load_pretrained_model",
                       functools.partial(jb.load_pretrained_model, dtype=jnp.float32))
        for mod in (tc, tv, tm):
            mp.setattr(mod, "load_pretrained_model",
                       functools.partial(tb.load_pretrained_model, dtype=torch.float32))
        yield types.SimpleNamespace(jc=jc, jv=jv, jm=jm, tc=tc, tv=tv, tm=tm)


def _write_images(folder, keys, seed, fmt="JPEG"):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for k in keys:
        h, w = rng.randint(20, 48, 2)
        PIL.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(os.path.join(folder, k),
                                                                     format=fmt)


@pytest.fixture(scope="module")
def cost_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cost")
    keys = [f"{i:012d}.jpg" for i in range(2)]
    _write_images(str(root / "val2017"), keys, 0)
    for i, task in enumerate(("semantic", "panoptic")):
        _write_images(str(root / f"{task}_inference"), keys, 1 + i, fmt="PNG")
    _write_images(str(root / "depth"), keys, 4, fmt="PNG")
    return root


def _cost_args(ckpt, root, out, **kw):
    args = dict(model_path=ckpt, model_base=None, image_folder=str(root / "val2017"),
                use_seg=True, seg_image_folder=str(root / "$TASK_inference"), use_depth=False,
                depth_image_folder=str(root / "depth"), output_file=str(out),
                conv_mode="llava_v1", num_chunks=1, chunk_idx=0, temperature=0.0, top_p=None,
                num_beams=1, batch_size=2, seed=0, lookahead=0, max_samples=None)
    args.update(kw)
    if not os.path.isabs(args["seg_image_folder"]):
        args["seg_image_folder"] = str(root / args["seg_image_folder"])
    return types.SimpleNamespace(**args)


COST_CASES = {
    "seg": ("semantic", {}),
    "seg_depth": ("depth", dict(use_depth=True, seg_image_folder="panoptic_inference")),
    "no_seg": ("panoptic", dict(use_seg=False)),
    "chunked": ("panoptic", dict(num_chunks=2, chunk_idx=1, seed=3)),
}


@pytest.mark.parametrize("case", sorted(COST_CASES))
def test_cost_loader_writes_jax_answers(ckpt, cost_tree, tmp_path, case):
    task, kw = COST_CASES[case]
    with f32_loaders() as m:
        want = m.jc.eval_model(_cost_args(ckpt, cost_tree, tmp_path / "jax" / "output", **kw),
                               task)
        got = m.tc.eval_model(_cost_args(ckpt, cost_tree, tmp_path / "torch" / "output",
                                         device="cpu", **kw), task)
    n = kw.get("num_chunks", 1)
    assert os.path.basename(got) == f"output_{task}_{n}_{kw.get('chunk_idx', 0)}.txt"
    text = open(got).read()
    assert text == open(want).read()
    assert text.count("-" * 55 + "\n") == (1 if n == 2 else 2)
    if case == "seg_depth":
        from vcoder_tpu_torch.eval.depth_accuracy import calculate_depth_score

        gt = tmp_path / "order.txt"
        gt.write_text("".join(f"<IMG>{i:012d}.jpg<IMG>The depth order for the objects present "
                              f"in the image is: person, car\n" for i in range(2)))
        scores = calculate_depth_score(str(gt), got)
        assert len(scores) == 2 and all(np.isfinite(s) and s >= 0 for s in scores)


def test_cost_loader_lookahead_matches_plain(ckpt, cost_tree, tmp_path):
    with f32_loaders() as m:
        plain = m.tc.eval_model(_cost_args(ckpt, cost_tree, tmp_path / "plain", device="cpu"),
                                "semantic")
        spec = m.tc.eval_model(_cost_args(ckpt, cost_tree, tmp_path / "spec", device="cpu",
                                          lookahead=8), "semantic")
    assert open(spec).read() == open(plain).read()


def test_depth_without_seg_raises_in_both(ckpt, cost_tree, tmp_path):
    with f32_loaders() as m:
        for mod, kw in ((m.jc, {}), (m.tc, {"device": "cpu"})):
            with pytest.raises(SystemExit, match="--use-depth requires --use-seg"):
                mod.eval_model(_cost_args(ckpt, cost_tree, tmp_path / "x", use_seg=False,
                                          use_depth=True, **kw), "depth")


def test_cost_loader_cli_parses_the_jax_flags():
    from vcoder_tpu_torch.eval import cost_loader

    args = cost_loader.build_parser().parse_args(
        ["--model-path", "m", "--use_seg", "--use-depth", "--tasks", "depth", "--lookahead",
         "8", "--max-samples", "4"])
    assert args.use_seg and args.use_depth and args.device == "cuda"
    assert (args.batch_size, args.lookahead, args.max_samples) == (8, 8, 4)


def _records(path, id_widths=(22,)):
    """The records without their random ``answer_id``s, whose widths must
    be in ``id_widths``: the port's are always 22 (``shortuuid``'s), the JAX
    package's 21 when the number has 21 base-57 digits."""
    out = []
    for line in open(path):
        rec = json.loads(line)
        assert len(rec.pop("answer_id")) in id_widths
        out.append(rec)
    return out


def test_answer_ids_are_shortuuid_wide(monkeypatch):
    """A number with fewer base-57 digits still gives 22 characters, padded
    with the alphabet's first, as ``shortuuid`` pads it."""
    import uuid

    from vcoder_tpu_torch.eval import shortuuid_like

    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=57 * 3 + 5))
    assert shortuuid_like.uuid() == "75" + "2" * 20
    monkeypatch.undo()
    assert all(len(shortuuid_like.uuid()) == 22 for _ in range(2000))


@pytest.mark.parametrize("single_pred", [False, True])
def test_vqa_loader_writes_jax_records(ckpt, tmp_path, single_pred):
    keys = [f"q{i}.jpg" for i in range(3)]
    _write_images(str(tmp_path / "imgs"), keys, 5)
    qfile = tmp_path / "questions.jsonl"
    qfile.write_text("".join(json.dumps({"question_id": i, "image": k, "category": "random",
                                         "text": "Is there a car in the image?"}) + "\n"
                             for i, k in enumerate(keys)))

    def args(out, **kw):
        return types.SimpleNamespace(
            model_path=ckpt, model_base=None, image_folder=str(tmp_path / "imgs"),
            question_file=str(qfile), answers_file=str(out), conv_mode="llava_v1",
            num_chunks=1, chunk_idx=0, temperature=0.0, top_p=None, num_beams=1,
            max_new_tokens=6, batch_size=2, single_pred_prompt=single_pred, lookahead=0, **kw)

    with f32_loaders() as m:
        m.jv.eval_model(args(tmp_path / "j.jsonl"))
        m.tv.eval_model(args(tmp_path / "t.jsonl", device="cpu"))
    got, want = _records(tmp_path / "t.jsonl"), _records(tmp_path / "j.jsonl", (21, 22))
    assert got == want and len(got) == 3
    assert got[0]["model_id"] == "vcoder_ds_llava-tiny"


def _b64(seed, fmt):
    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    PIL.fromarray(rng.randint(0, 255, (30, 26, 3), np.uint8)).save(buf, format=fmt)
    return base64.b64encode(buf.getvalue()).decode()


def _mmbench_args(ckpt, tsv, out, **kw):
    return types.SimpleNamespace(
        model_path=ckpt, model_base=None, question_file=str(tsv), answers_file=str(out),
        conv_mode="llava_v1", num_chunks=1, chunk_idx=0, temperature=0.0, top_p=None,
        num_beams=1, max_new_tokens=4, all_rounds=True, single_pred_prompt=True, lang="en", **kw)


def test_mmbench_loader_writes_jax_records(ckpt, tmp_path):
    pd = pytest.importorskip("pandas")
    rows = [
        {"index": 0, "question": "What is it?", "hint": "A hint.", "A": "cat", "B": "dog",
         "C": "car", "D": float("nan"), "image": _b64(0, "PNG")},
        {"index": 1, "question": "Which color?", "hint": float("nan"), "A": "red", "B": "blue",
         "C": float("nan"), "D": float("nan"), "image": _b64(1, "JPEG")},
    ]
    tsv = tmp_path / "mmb.tsv"
    pd.DataFrame(rows).to_csv(tsv, sep="\t", index=False)
    with f32_loaders() as m:
        m.jm.eval_model(_mmbench_args(ckpt, tsv, tmp_path / "j.jsonl"))
        m.tm.eval_model(_mmbench_args(ckpt, tsv, tmp_path / "t.jsonl", device="cpu"))
    got, want = _records(tmp_path / "t.jsonl"), _records(tmp_path / "j.jsonl", (21, 22))
    assert [r["round_id"] for r in got] == [0, 1, 2, 0, 1]
    assert got[1]["options"] == ["dog", "car", "cat"]
    # The JAX loader pads and resizes the decoded image natively, the port's
    # processor in torch (within a level of each other); the greedy tokens
    # agree on these inputs.
    assert got == want


def test_mmbench_loader_names_pandas_when_missing(ckpt, tmp_path, monkeypatch):
    from vcoder_tpu_torch.eval import mmbench_loader

    real_import = builtins.__import__

    def no_pandas(name, *args, **kw):
        if name == "pandas" or name.startswith("pandas."):
            raise ImportError("No module named 'pandas'")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pandas)
    with pytest.raises(ImportError, match="pandas"):
        mmbench_loader.eval_model(_mmbench_args(ckpt, tmp_path / "x.tsv", tmp_path / "o.jsonl",
                                                device="cpu"))
