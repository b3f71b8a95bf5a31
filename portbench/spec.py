"""What the benchmark runs, found by name in its data files.

* ``BENCHMARK.json`` at the root of the checkout: cells, configurations and
  metrics.
* ``portbench/cells/<cell>.json``: the cell's configuration, traffic mix,
  chips, the system's parameters and its ``why``.
* ``portbench/configs/<config>.json``: the model, as the published config
  names its sizes, plus the VCoder-DS parts (``vcoder``).
* ``portbench/traffic/<mix>.json``: the mix's parameters, read by the one
  generator in ``traffic.py``.
* ``portbench/metrics/<metric>.py``: the reader of one metric (``read``);
  for a metric ``<quantity>.<part>`` without a file of its own,
  ``metrics/<quantity>.py``, the reader of every part of that quantity.

A later change adds a cell, a configuration, a mix or a metric as new files
and entries; nothing here names one. Every loader takes the directory it
reads, so a test can point it at a fixture.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(folder: Path, name: str, suffix: str) -> Path:
    if not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    path = folder / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(folder.parent)}")
    return path


def benchmark(root: Path = ROOT) -> dict:
    return _load_json(root / "BENCHMARK.json")


def cell(name: str, folder: Path = HERE / "cells") -> dict:
    c = _load_json(_by_name(folder, name, ".json"))
    c["name"] = name
    return c


def config(name: str, folder: Path = HERE / "configs") -> dict:
    return _load_json(_by_name(folder, name, ".json"))


def mix(name: str, folder: Path = HERE / "traffic") -> dict:
    m = _load_json(_by_name(folder, name, ".json"))
    m["name"] = name
    return m


def metric_reader(name: str, folder: Path = HERE / "metrics"):
    """The module of ``metrics/<name>.py``, else of the reader of its
    quantity (the name up to its first dot): ``read(run) -> float or
    None``."""
    quantity = name.split(".")[0]
    if not (folder / f"{name}.py").is_file() and (folder / f"{quantity}.py").is_file():
        name = quantity
    path = _by_name(folder, name, ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of ``cell_name`` reports: the end-to-end
    ones with ``trace`` off, the per-layer ones with it on; an entry with
    ``workloads`` only in those cells."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell_name in m.get("workloads", [cell_name])]


def model_config(cfg: dict):
    """The port's ``VCoderConfig`` for a configuration file (imported here,
    so that loading data needs no port)."""
    from vcoder_tpu_torch.config import TextConfig, VCoderConfig, VisionConfig

    v = cfg["vcoder"]
    text = TextConfig(
        vocab_size=cfg["vocab_size"],
        hidden_size=cfg["hidden_size"],
        intermediate_size=cfg["intermediate_size"],
        num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        rope_theta=float(cfg["rope_theta"]),
        rms_norm_eps=float(cfg["rms_norm_eps"]),
        max_position_embeddings=cfg["max_position_embeddings"],
        bos_token_id=cfg["bos_token_id"],
        eos_token_id=cfg["eos_token_id"],
        pad_token_id=0,
    )
    vision = VisionConfig(**v["vision"])
    flags = dict(use_seg=True, use_depth=True, use_mm2_proj=True, use_vcoder_lm_emb=True)
    return VCoderConfig(model_type=v["model_type"], vision=vision, text=text,
                        mm_projector_type=v["mm_projector_type"],
                        seg_mm_projector_type=v["mm_projector_type"],
                        depth_mm_projector_type=v["mm_projector_type"],
                        model_max_length=v["model_max_length"], **flags)


def dims(cfg: dict) -> dict:
    """The sizes the counts and the reference read, from a configuration
    file alone."""
    v = cfg["vcoder"]["vision"]
    H = cfg["num_attention_heads"]
    return dict(
        V=cfg["vocab_size"], D=cfg["hidden_size"], I=cfg["intermediate_size"],
        L=cfg["num_hidden_layers"], H=H, KH=cfg["num_key_value_heads"],
        HD=cfg["hidden_size"] // H, theta=float(cfg["rope_theta"]),
        eps=float(cfg["rms_norm_eps"]), bos=cfg["bos_token_id"],
        Dv=v["hidden_size"], Iv=v["intermediate_size"], Lv=v["num_layers"],
        Hv=v["num_heads"], image=v["image_size"], patch=v["patch_size"],
        select=v["select_layer"], veps=v["layer_norm_eps"],
        dtype=cfg.get("torch_dtype", "bfloat16"),
        n_patches=(v["image_size"] // v["patch_size"]) ** 2,
        tower_blocks=v["num_layers"] + 1 + v["select_layer"] if v["select_layer"] < 0
        else v["select_layer"],
    )


def seed_stream(seed: int, *tags) -> np.random.Generator:
    """A host generator for one stream of a run, from ``--seed`` and tags
    (any whole number, also one past 32 bits)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for t in tags:
        words.append(int.from_bytes(hashlib.sha256(str(t).encode()).digest()[:4], "little"))
    return np.random.default_rng(np.random.SeedSequence(words))


def torch_seed(seed: int, *tags) -> int:
    """A 63-bit seed for a ``torch.Generator`` of one stream."""
    return int(seed_stream(seed, "torch", *tags).integers(0, 2**63 - 1))


def check_names(bench: dict) -> Optional[str]:
    """The first name in ``bench`` that breaks the contract's rule, or None."""
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[key]:
            if not NAME.match(e["name"]):
                return e["name"]
    return None
