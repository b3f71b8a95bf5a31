"""The port's COST training streams and ``VCoderDataset`` against the JAX
package's (CPU), on tests/test_train_pipeline.py's synthetic COST tree.

Mirrors that file's dataset tests. The stream builders draw from Python and
numpy RNGs seeded per builder, so for the same seed and files their entry
lists must be equal, list for list. Dataset items (pixels through the
native image library on both sides, normalized on the host) and their
collated batches must equal JAX's arrays; ``generate_qa_pairs`` must give
JAX's pairs from the same global RNG state.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

PIL = pytest.importorskip("PIL.Image")

from tests.test_train_pipeline import KEYS, _make_cost_tree  # noqa: E402
from vcoder_tpu import data_utils as jdu  # noqa: E402
from vcoder_tpu.config import VCoderConfig as JConfig  # noqa: E402
from vcoder_tpu.train import collator as jcol  # noqa: E402
from vcoder_tpu.train import datasets as jds  # noqa: E402
from vcoder_tpu_torch import data_utils as tdu  # noqa: E402
from vcoder_tpu_torch.train import collator as tcol  # noqa: E402
from vcoder_tpu_torch.train import datasets as tds  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cost")
    _make_cost_tree(str(root))
    return str(root)


def test_obtain_seg_texts_dedup(tmp_path):
    p = tmp_path / "x.txt"
    p.write_text("<IMG>a.jpg<IMG>wall, person, wall, window, window\n")
    out = tds.obtain_seg_texts(str(p))
    assert out["a.jpg"].count("wall") == 1 and out["a.jpg"].count("window") == 1
    assert tds.obtain_depth_texts(str(p)) == jds.obtain_depth_texts(str(p))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("with_depth", [False, True])
def test_build_seg_cost_entries_match_jax(tree, seed, with_depth):
    got = tds.build_seg_cost_entries(tree, seed=seed, with_depth=with_depth)
    assert got == jds.build_seg_cost_entries(tree, seed=seed, with_depth=with_depth)
    assert len(got) == len(KEYS) * 3
    tail = "\n<image>\n<seg>" + ("\n<depth>" if with_depth else "")
    assert got[0]["conversations"][0]["value"].endswith(tail)
    assert ("depth_folder" in got[0]) == with_depth


def test_depth_stream_is_panoptic_only(tree):
    d = tds.build_seg_cost_entries(tree, seed=0, with_depth=True)
    assert d and all(e["seg_folder"].endswith("panoptic_inference") for e in d)
    folders = {e["seg_folder"].rsplit("/", 1)[-1] for e in tds.build_seg_cost_entries(tree, seed=0)}
    assert len(folders) > 1, folders


def test_depth_and_count_streams_match_jax(tree, tmp_path):
    """The depth-order stream, and the 1% count-QA stream over a panoptic.txt
    of 600 keys (so the gate passes some), equal JAX's; the count stream
    leaves the global RNG streams as it found them."""
    got = tds.get_depth_data_split(tree, seed=2)
    assert got == jds.get_depth_data_split(tree, seed=2) and len(got) == len(KEYS) * 3
    segm = tmp_path / "coco_segm_text" / "train"
    segm.mkdir(parents=True)
    objs = ["two people, a car, wall", "three dogs, a bench", "a person, eighteen bottles, sky"]
    (segm / "panoptic.txt").write_text("".join(
        f"<IMG>k{i}.jpg<IMG>The objects present in the image are: {objs[i % 3]}\n"
        for i in range(600)))
    random.seed(123)
    np.random.seed(123)
    before = (random.getstate(), np.random.get_state()[1].copy())
    got = tds.get_extra_count_data_split(str(tmp_path), seed=5)
    assert random.getstate() == before[0]
    assert np.array_equal(np.random.get_state()[1], before[1])
    assert got == jds.get_extra_count_data_split(str(tmp_path), seed=5)
    assert got and all("conversations" in e and "seg" in e for e in got)


def test_mix_streams_match_jax(tree, tmp_path):
    """The two stage-3 streams over a LLaVA-mix json (``obtain_seg_data_splits``
    with 30% inserted seg QA, ``obtain_seg_depth_data_splits`` with depth
    QA) equal JAX's."""
    mix = [{"id": str(i), "image": f"coco/train2017/{k}",
            "conversations": [{"from": "human", "value": "<image>\nWhat is this?"},
                              {"from": "gpt", "value": "a car"},
                              {"from": "human", "value": "And?"},
                              {"from": "gpt", "value": "a wall"}]}
           for i, k in enumerate(KEYS * 4)]
    mix.append({"id": "text", "conversations": [{"from": "human", "value": "hi"},
                                                 {"from": "gpt", "value": "hello"}]})
    path = tmp_path / "mix.json"
    path.write_text(json.dumps(mix))
    for seed in (0, 1):
        got = tds.obtain_seg_data_splits(str(path), tree, tree, seed=seed)
        assert got == jds.obtain_seg_data_splits(str(path), tree, tree, seed=seed)
        got_d = tds.obtain_seg_depth_data_splits(str(path), tree, tree, seed=seed)
        assert got_d == jds.obtain_seg_depth_data_splits(str(path), tree, tree, seed=seed)
    assert len(got) == len(got_d) == len(KEYS) * 4


def test_generate_qa_pairs_match_jax():
    text = ("The objects present in the image are: wall, dining table, two people, "
            "eighteen bottles")
    for seed in range(5):
        outs = []
        for mod in (jdu, tdu):
            random.seed(seed)
            np.random.seed(seed)
            outs.append(mod.generate_qa_pairs(text))
        assert outs[1] == outs[0]
        assert 1 <= len(outs[1]) <= 6
        for q, a in outs[1]:
            assert q.endswith("in the image?")
            assert a in ("Yes.", "No.") or a.endswith("in the image.")


def _datasets(tree, tok, aspect="pad"):
    cfg = JConfig.tiny("vcoder_ds_llava")
    entries = jds.build_seg_cost_entries(tree, buckets=("train",), seed=0, with_depth=True)
    kw = dict(image_folder=tree, seg_data_path=tree, depth_data_path=tree,
              image_size=cfg.vision.image_size, image_aspect_ratio=aspect, use_seg=True,
              use_depth=True, model_max_length=cfg.model_max_length)
    return cfg, jds.VCoderDataset(entries, tok, **kw), tds.VCoderDataset(entries, tok, **kw)


@pytest.mark.parametrize("aspect", ["pad", "square"])
def test_dataset_items_and_batches_match_jax(tree, fake_tokenizer, aspect):
    cfg, jd, td = _datasets(tree, fake_tokenizer, aspect)
    assert len(td) == len(jd) and td.modality_lengths == jd.modality_lengths
    for i in range(len(td)):
        a, b = jd[i], td[i]
        assert set(b) == set(a) == {"input_ids", "labels", "image", "seg", "depth"}
        for k in a:
            np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=k)
    assert b["image"].shape == (28, 28, 3) and b["image"].dtype == np.float32
    assert td.routes == {"native": 3 * len(td), "png": 0, "PIL": 0}
    kw = dict(num_patches=cfg.vision.num_patches, ds_mode=True, use_seg=True, use_depth=True,
              image_size=cfg.vision.image_size, pad_multiple=16)
    ref = jcol.collate_batch([jd[0], jd[1]], as_jnp=False, **kw)
    got = tcol.collate_batch([td[0], td[1]], device="cpu", **kw)
    assert got["images"].shape == (2, 28, 28, 3)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_modality_lengths_double_negation():
    ds = tds.VCoderDataset.__new__(tds.VCoderDataset)
    ds.entries = [
        {"conversations": [{"value": "a b c"}], "image": "i", "seg": "s"},
        {"conversations": [{"value": "a b c"}], "image": "i"},
        {"conversations": [{"value": "a b c"}]},
    ]
    assert ds.modality_lengths == [3, -3, 3]


def test_rejected_file_goes_through_pil_or_raises_without_it(tmp_path, fake_tokenizer,
                                                             monkeypatch):
    """A file the native library rejects (a BMP here) is read by PIL's
    decode, pad and resize, as the JAX dataset reads it; without PIL it is a
    ``ValueError`` that names the file. A missing file stays a missing file."""
    tree = str(tmp_path)
    _make_cost_tree(tree)
    _, jd, td = _datasets(tree, fake_tokenizer)
    entry = jd.entries[0]
    path = os.path.join(tree, entry["image"])
    PIL.open(path).save(path + ".bmp", format="BMP")
    os.replace(path + ".bmp", path)
    np.testing.assert_array_equal(td[0]["image"], jd[0]["image"])
    assert td.routes["PIL"] == 1
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ValueError, match=os.path.basename(path)):
        td[0]
    monkeypatch.undo()
    os.remove(path)
    with pytest.raises(FileNotFoundError):
        td[0]
