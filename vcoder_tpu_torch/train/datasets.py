"""COST / LLaVA training datasets and data-stream builders (port of
``vcoder_tpu/train/datasets.py``).

The stream builders (``:38-381``) are a copy: the reference's folder
conventions, probability gates, question sampling and stream
concatenation for every training stage (reference:
train/vcoder_train.py:310-462 ``LazySegSupervisedDataset``;
train/vcoder_ds_train.py:350-658 the six stage-3 streams), with randomness
from one seeded ``random.Random`` + ``numpy.random.RandomState`` pair per
builder. For the same seed and files they give the JAX package's entries,
list for list.

:class:`VCoderDataset` (``:382-532``) loads an entry's pictures through the
port's native image library (``native_io.py``: libjpeg, or nvJPEG where
libjpeg's headers are missing, decoding a PNG by ``png.py`` there) and
normalizes them on the host; a file the library rejects goes through PIL
where it is installed, else raises a ``ValueError`` naming it. ``routes``
counts how the dataset's files were decoded.
"""

from __future__ import annotations

import copy
import json
import os
import random as _random_mod
import threading
from typing import Dict, List

import numpy as np

from vcoder_tpu_torch.data_utils import generate_qa_pairs
from vcoder_tpu_torch.eval.extraction import obtain_seg_texts
from vcoder_tpu_torch.questions import (
    DEPTH_QUESTIONS,
    INSTANCE_QUESTIONS,
    PANOPTIC_QUESTIONS,
    SEMANTIC_QUESTIONS,
)
from vcoder_tpu_torch.train.preprocess import preprocess, relocate_sentinels

GENERIC_QUESTION = "What objects can be seen in the image?"


def obtain_depth_texts(file_path: str) -> Dict[str, str]:
    """reference: vcoder_ds_train.py:300-310 (no dedup)."""
    return obtain_seg_texts(file_path, dedup=False)


def _pick_task_question(
    rng: np.random.RandomState,
    pyrng: "_random_mod.Random",
    labels: Dict[str, Dict[str, str]],
    key: str,
):
    """Random task in {semantic, instance, panoptic} with the reference's
    0.33/0.66 gates and 0.90 generic-question gate
    (vcoder_train.py:327-352)."""
    prob_task = rng.uniform(0, 1.0)
    question_prob = rng.uniform(0, 1.0)
    if prob_task < 0.33:
        task, bank = "semantic", SEMANTIC_QUESTIONS
    elif prob_task < 0.66:
        task, bank = "instance", INSTANCE_QUESTIONS
    else:
        task, bank = "panoptic", PANOPTIC_QUESTIONS
    answer = labels[task][key]
    question = (
        GENERIC_QUESTION if question_prob > 0.90 else pyrng.choice(bank)
    )
    return task, question, answer


def _qa(question: str, answer: str) -> List[dict]:
    return [
        {"from": "human", "value": question},
        {"from": "gpt", "value": answer},
    ]


# ---------------------------------------------------------------------------
# Stage-2 (VCoder) stream: COST seg over train/unlabeled/test buckets
# ---------------------------------------------------------------------------


def build_seg_cost_entries(
    seg_data_path: str,
    *,
    buckets=("train", "unlabeled", "test"),
    seed: int = 0,
    with_depth: bool = False,
) -> List[dict]:
    """reference: LazySegSupervisedDataset.__init__
    (vcoder_train.py:310-380) and get_object_data_split
    (vcoder_ds_train.py:500-556). ``with_depth=True`` follows
    get_object_data_depth_split (:461-497) exactly: PANOPTIC-only
    answers and a 50000-entry post-shuffle cap — the seg-only stream
    mixes tasks uncapped."""
    rng = np.random.RandomState(seed)
    pyrng = _random_mod.Random(seed)
    entries = []
    for bucket in buckets:
        base = os.path.join(seg_data_path, "coco_segm_text", bucket)
        labels = {
            "panoptic": obtain_seg_texts(os.path.join(base, "panoptic.txt")),
            "semantic": obtain_seg_texts(os.path.join(base, "semantic.txt")),
            "instance": obtain_seg_texts(os.path.join(base, "instance.txt")),
        }
        for key in labels["panoptic"]:
            assert key in labels["semantic"] and key in labels["instance"], (
                "Instance, semantic, and panoptic labels should have the"
                " same keys."
            )
            if with_depth:
                # Depth-object stream: panoptic only (reference
                # get_object_data_depth_split draws no task prob).
                task = "panoptic"
                answer = labels["panoptic"][key]
                question = (
                    GENERIC_QUESTION
                    if rng.uniform(0, 1.0) > 0.90
                    else pyrng.choice(PANOPTIC_QUESTIONS)
                )
            else:
                task, question, answer = _pick_task_question(
                    rng, pyrng, labels, key
                )
            suffix = "\n<image>\n<seg>" + ("\n<depth>" if with_depth else "")
            entry = {
                "conversations": _qa(question + suffix, answer),
                "image": f"coco/{bucket}2017/{key}",
                "seg": key,
                "seg_folder": f"coco_segm_text/{bucket}/{task}_inference",
            }
            if with_depth:
                entry["depth"] = key
                entry["depth_folder"] = (
                    f"coco_segm_text/depth/{bucket}/depth"
                )
            entries.append(entry)
    pyrng.shuffle(entries)
    if with_depth:
        entries = entries[:50000]  # reference cap (vcoder_ds_train.py:497)
    return entries


# ---------------------------------------------------------------------------
# Stage-3 (VCoder-DS) streams (reference: vcoder_ds_train.py:350-658)
# ---------------------------------------------------------------------------

_SEG_FOLDER_BY_SOURCE = [
    ("coco", "coco_segm_text/train/panoptic_inference"),
    ("gqa", "gqa/seg_images/panoptic_inference"),
    ("VG_100K_2", "vg/vg/SEG_VG_100K_2/panoptic_inference"),
    ("VG_100K", "vg/vg/SEG_VG_100K/panoptic_inference"),
    ("ocr_vqa", "ocr_vqa/seg_images/panoptic_inference"),
    ("textvqa", "textvqa/seg_images/panoptic_inference"),
]


def obtain_seg_data_splits(
    data_path: str,
    image_folder: str,
    seg_image_folder: str,
    *,
    cap: int = 200000,
    seed: int = 0,
) -> List[dict]:
    """LLaVA-mix conversations + <seg> sentinel + 30% inserted seg-QA
    (reference: vcoder_ds_train.py:350-418)."""
    rng = np.random.RandomState(seed)
    pyrng = _random_mod.Random(seed)
    data_dict = json.load(open(data_path))
    entries = []
    for l in data_dict:
        if "image" not in l:
            continue
        if not os.path.exists(os.path.join(image_folder, l["image"])):
            continue
        seg_folder = None
        for marker, folder in _SEG_FOLDER_BY_SOURCE:
            if marker in l["image"]:
                seg_folder = folder
                break
        if seg_folder is None:
            continue
        l = copy.deepcopy(l)
        l["seg"] = l["image"].split("/")[-1]
        l["seg_folder"] = seg_folder
        for c in l["conversations"]:
            if "<image>" in c["value"]:
                c["value"] = c["value"].replace("<image>", "<image>\n<seg>")
        if l["conversations"]:
            entries.append(l)

    labels_dict = {}
    for _, folder in _SEG_FOLDER_BY_SOURCE:
        root = folder.split("/panoptic_inference")[0]
        path = os.path.join(seg_image_folder, root, "panoptic.txt")
        if os.path.exists(path):
            labels_dict[root] = obtain_seg_texts(path)

    pyrng.shuffle(entries)
    entries = entries[:cap]
    final = []
    for l in entries:
        prob_add = rng.uniform(0, 1.0)
        if prob_add > 0.7:
            root = l["seg_folder"].split("/panoptic_inference")[0]
            labels = labels_dict.get(root, {})
            if l["seg"] in labels:
                conversations = l["conversations"]
                even_indices = list(range(2, len(conversations) + 1, 2))
                if not even_indices:
                    # Single-turn entry: nowhere to insert; keep as-is
                    # instead of crashing the whole dataset build.
                    final.append(l)
                    continue
                idx = pyrng.choice(even_indices)
                question_prob = rng.uniform(0, 1.0)
                question = (
                    GENERIC_QUESTION
                    if question_prob > 0.90
                    else pyrng.choice(PANOPTIC_QUESTIONS)
                )
                l["conversations"] = (
                    conversations[:idx]
                    + _qa(question, labels[l["seg"]])
                    + conversations[idx:]
                )
        final.append(l)
    return final


def obtain_seg_depth_data_splits(
    data_path: str,
    image_folder: str,
    depth_data_path: str,
    *,
    cap: int = 100000,
    seed: int = 1,
) -> List[dict]:
    """COCO subset with seg+depth sentinels + 30% inserted depth-QA
    (reference: vcoder_ds_train.py:419-455)."""
    rng = np.random.RandomState(seed)
    pyrng = _random_mod.Random(seed)
    data_dict = json.load(open(data_path))
    labels = obtain_depth_texts(
        os.path.join(
            depth_data_path, "coco_segm_text", "depth", "train",
            "panoptic_order.txt",
        )
    )
    entries = []
    for l in data_dict:
        if "image" not in l or "coco" not in l["image"]:
            continue
        if not os.path.exists(os.path.join(image_folder, l["image"])):
            continue
        l = copy.deepcopy(l)
        key = l["image"].split("/")[-1]
        l["seg"] = key
        l["depth"] = key
        l["seg_folder"] = "coco_segm_text/train/panoptic_inference"
        l["depth_folder"] = "coco_segm_text/depth/train/depth"
        for c in l["conversations"]:
            if "<image>" in c["value"]:
                c["value"] = c["value"].replace(
                    "<image>", "<image>\n<seg>\n<depth>"
                )
        if l["conversations"]:
            entries.append(l)
    pyrng.shuffle(entries)
    entries = entries[:cap]
    final = []
    for l in entries:
        if rng.uniform(0, 1.0) > 0.7 and l["seg"] in labels:
            conversations = l["conversations"]
            even_indices = list(range(2, len(conversations) + 1, 2))
            if not even_indices:
                final.append(l)
                continue
            idx = pyrng.choice(even_indices)
            l["conversations"] = (
                conversations[:idx]
                + _qa(pyrng.choice(DEPTH_QUESTIONS), labels[l["seg"]])
                + conversations[idx:]
            )
        final.append(l)
    return final


def get_depth_data_split(
    depth_data_path: str,
    *,
    buckets=("train", "unlabeled", "test"),
    seed: int = 2,
) -> List[dict]:
    """Depth-order QA over panoptic_order.txt
    (reference: vcoder_ds_train.py:556-588)."""
    pyrng = _random_mod.Random(seed)
    entries = []
    for bucket in buckets:
        labels = obtain_depth_texts(
            os.path.join(
                depth_data_path, "coco_segm_text", "depth", bucket,
                "panoptic_order.txt",
            )
        )
        for key, answer in labels.items():
            question = (
                pyrng.choice(DEPTH_QUESTIONS) + "\n<image>\n<seg>\n<depth>"
            )
            entries.append(
                {
                    "conversations": _qa(question, answer),
                    "image": f"coco/{bucket}2017/{key}",
                    "seg": key,
                    "depth": key,
                    "seg_folder": (
                        f"coco_segm_text/{bucket}/panoptic_inference"
                    ),
                    "depth_folder": f"coco_segm_text/depth/{bucket}/depth",
                }
            )
    pyrng.shuffle(entries)
    return entries


def get_extra_count_data_split(
    seg_image_folder: str, *, seed: int = 3
) -> List[dict]:
    """1% synthetic count-QA stream
    (reference: vcoder_ds_train.py:590-628)."""
    rng = np.random.RandomState(seed)
    pyrng = _random_mod.Random(seed)
    # generate_qa_pairs draws from the module-level RNGs: seed them for
    # determinism but RESTORE the global streams afterwards — builders
    # must not clobber global RNG state as a side effect.
    py_state = _random_mod.getstate()
    np_state = np.random.get_state()
    _random_mod.seed(seed)
    np.random.seed(seed)
    bucket = "train"
    labels = obtain_seg_texts(
        os.path.join(
            seg_image_folder, "coco_segm_text", bucket, "panoptic.txt"
        )
    )
    entries = []
    for key, answer in labels.items():
        if rng.uniform(0, 1.0) > 0.99:
            qa_pairs = generate_qa_pairs(answer)
            if len(qa_pairs) >= 1:
                conversations = []
                for idx, qa_pair in enumerate(qa_pairs):
                    conversations.append(
                        {
                            "from": "human",
                            "value": qa_pair[0] + "\n<image>\n<seg>"
                            if idx == 0
                            else qa_pair[0],
                        }
                    )
                    conversations.append(
                        {"from": "gpt", "value": qa_pair[1]}
                    )
                entries.append(
                    {
                        "conversations": conversations,
                        "image": f"coco/{bucket}2017/{key}",
                        "seg": key,
                        "seg_folder": (
                            f"coco_segm_text/{bucket}/panoptic_inference"
                        ),
                    }
                )
    _random_mod.setstate(py_state)
    np.random.set_state(np_state)
    pyrng.shuffle(entries)
    return entries


# ---------------------------------------------------------------------------
# Dataset
# ---------------------------------------------------------------------------


class VCoderDataset:
    """Lazy multimodal dataset over mixed entries.

    Each entry: {conversations, image?, seg?, seg_folder?, depth?,
    depth_folder?}. ``__getitem__`` loads + preprocesses pixels, relocates
    sentinels, tokenizes, and masks instructions — the functional
    equivalent of the reference's three Lazy*SupervisedDataset classes.
    """

    def __init__(
        self,
        entries: List[dict],
        tokenizer,
        *,
        image_folder: str = "",
        seg_data_path: str = "",
        depth_data_path: str = "",
        image_size: int = 336,
        image_aspect_ratio: str = "pad",
        version: str = "v1",
        model_max_length: int = 2048,
        use_seg: bool = False,
        use_depth: bool = False,
    ):
        self.entries = entries
        self.tokenizer = tokenizer
        self.image_folder = image_folder
        self.seg_data_path = seg_data_path
        self.depth_data_path = depth_data_path
        self.image_size = image_size
        self.image_aspect_ratio = image_aspect_ratio
        self.version = version
        self.model_max_length = model_max_length
        self.use_seg = use_seg
        self.use_depth = use_depth
        # How the files were decoded: "native", "png" (png.py where the
        # library decodes no PNG) or "PIL"; the loader threads share it.
        self.routes = {"native": 0, "png": 0, "PIL": 0}
        self._routes_lock = threading.Lock()

    def __len__(self):
        return len(self.entries)

    @property
    def modality_lengths(self) -> List[int]:
        """Sign flips once per MISSING modality (image, then seg) —
        the reference's exact double-negation, where a text-only sample
        flips twice back to positive (vcoder_train.py:393-400). Quirk
        preserved for sampler parity."""
        out = []
        for sample in self.entries:
            cur_len = sum(
                len(c["value"].split()) for c in sample["conversations"]
            )
            if "image" not in sample:
                cur_len = -cur_len
            if "seg" not in sample:
                cur_len = -cur_len
            out.append(cur_len if cur_len != 0 else 1)
        return out

    def _load_pixels(self, path: str) -> np.ndarray:
        """A file -> normalized f32 [S, S, 3] on the host: decode, pad (or
        center-crop) and bicubic resize in the native library; a PNG it does
        not decode (the nvJPEG route) through ``png.py``, then the native
        pad and resize; a file it rejects through PIL's decode, pad and
        resize, as the JAX package's fallback (``:457-490``), where PIL is
        installed, else a ``ValueError`` naming it."""
        from vcoder_tpu_torch import native_io
        from vcoder_tpu_torch.preprocess import (
            BACKGROUND_COLOR,
            CLIP_IMAGE_MEAN,
            CLIP_IMAGE_STD,
            _decode,
            expand2square,
        )

        S = self.image_size
        pad = self.image_aspect_ratio == "pad"
        try:
            u8 = native_io.load_preprocessed(path, size=S, pad=pad)
            route = "native"
        except IOError:
            if not os.path.exists(path):
                raise FileNotFoundError(path) from None
            arr, route = _decode(path)
            if route != "PIL":
                u8 = native_io.pad_resize(arr, size=S, pad=pad)
            else:
                from PIL import Image

                if pad:
                    arr = expand2square(arr, BACKGROUND_COLOR)
                else:
                    side = min(arr.shape[:2])
                    top = (arr.shape[0] - side) // 2
                    left = (arr.shape[1] - side) // 2
                    arr = arr[top : top + side, left : left + side]
                if arr.shape[0] != S:
                    resample = getattr(Image, "Resampling", Image).BICUBIC
                    arr = np.asarray(Image.fromarray(arr).resize((S, S), resample))
                u8 = arr
        with self._routes_lock:
            self.routes[route] += 1
        x = u8.astype(np.float32) / 255.0
        mean = np.asarray(CLIP_IMAGE_MEAN, np.float32)
        std = np.asarray(CLIP_IMAGE_STD, np.float32)
        return (x - mean) / std

    def __getitem__(self, i: int) -> dict:
        entry = self.entries[i]
        sources = [copy.deepcopy(entry["conversations"])]
        has_image = "image" in entry
        has_seg = "seg" in entry and self.use_seg
        has_depth = "depth" in entry and self.use_depth

        out: dict = {}
        if has_image:
            out["image"] = self._load_pixels(
                os.path.join(self.image_folder, entry["image"])
            )
            if has_seg:
                out["seg"] = self._load_pixels(
                    os.path.join(
                        self.seg_data_path,
                        entry["seg_folder"],
                        entry["seg"],
                    )
                )
            if has_depth:
                out["depth"] = self._load_pixels(
                    os.path.join(
                        self.depth_data_path or self.seg_data_path,
                        entry["depth_folder"],
                        entry["depth"],
                    )
                )
            sources = relocate_sentinels(
                sources, use_seg=has_seg, use_depth=has_depth
            )

        data = preprocess(
            sources,
            self.tokenizer,
            has_image=has_image,
            has_seg=has_seg,
            has_depth=has_depth,
            version=self.version,
            model_max_length=self.model_max_length,
        )
        out["input_ids"] = data["input_ids"][0]
        out["labels"] = data["labels"][0]
        return out
