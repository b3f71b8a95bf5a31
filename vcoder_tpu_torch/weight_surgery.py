"""Checkpoint weight surgery: delta make/apply, consolidation, LoRA merge.

A port of ``vcoder_tpu/weight_surgery.py`` onto the port's own safetensors
reader and writer (``checkpoint.read_safetensors``/``write_safetensors``,
``load_state``). It mirrors the reference tools (reference:
vcoder_llava/model/make_delta.py, apply_delta.py, consolidate.py) on
HF-layout state dicts. This is host work: CPU tensors, no device.

* ``make_delta``: delta = target - base, with the embed-size mismatch rule
  (rows and columns beyond the base stay absolute — make_delta.py:23-33).
* ``apply_delta``: target = base + delta, the inverse rule (apply_delta.py).
* ``consolidate``: re-save a checkpoint directory as one file.
* ``merge_lora``: fold a ``Trainer.save_adapters`` file (leaf-path keys such
  as ``lm/layers/q_proj/a``, the ``tree.py`` convention) into a base.

Usage:
    python -m vcoder_tpu_torch.weight_surgery make-delta --base b --target t --delta d
    python -m vcoder_tpu_torch.weight_surgery apply-delta --base b --delta d --target t
    python -m vcoder_tpu_torch.weight_surgery consolidate --src s --dst d
    python -m vcoder_tpu_torch.weight_surgery merge-lora --base b --adapters a --target t
"""

from __future__ import annotations

import argparse
import os
import shutil
from typing import Dict

import torch

from vcoder_tpu_torch.checkpoint import (
    load_hf_checkpoint,
    load_state,
    read_safetensors,
    save_pretrained,
    write_safetensors,
)

EMBED_KEYS = ("model.embed_tokens.weight", "lm_head.weight",
              "model.vcoder_lm_emb.weight")

StateDict = Dict[str, torch.Tensor]


def _save_state(state: StateDict, model_dir: str) -> None:
    os.makedirs(model_dir, exist_ok=True)
    write_safetensors(os.path.join(model_dir, "model.safetensors"), state)


_TOKENIZER_FILES = (
    "vcoder_tokenizer.json",
    "tokenizer.model",
    "tokenizer.json",
    "tokenizer_config.json",
    "special_tokens_map.json",
)


def _copy_config(src: str, dst: str, *, config: bool = True) -> None:
    """Carry config + tokenizer files into a surgery output (the reference
    tools call tokenizer.save_pretrained on every output — without the
    tokenizer files the result can't serve)."""
    names = _TOKENIZER_FILES + (("config.json",) if config else ())
    for name in names:
        p = os.path.join(src, name)
        if os.path.exists(p):
            shutil.copy(p, os.path.join(dst, name))


def make_delta(base_dir: str, target_dir: str, delta_dir: str) -> None:
    base = load_state(base_dir)
    target = load_state(target_dir)
    delta: StateDict = {}
    for name, param in target.items():
        if name not in base:
            # Modules absent from the base (adapters) stay absolute.
            delta[name] = param
            continue
        bparam = base[name]
        if param.shape == bparam.shape:
            delta[name] = param - bparam
        else:
            # Embedding grew (extra tokens): subtract over the shared rows
            # and columns, keep the rest absolute (make_delta.py:23-33).
            assert name in EMBED_KEYS, f"{name} has unexpected shape change"
            d = param.to(torch.float32).clone()
            d[: bparam.shape[0], : bparam.shape[1]] -= bparam.to(torch.float32)
            delta[name] = d.to(param.dtype)
    _save_state(delta, delta_dir)
    _copy_config(target_dir, delta_dir)


def apply_delta(base_dir: str, delta_dir: str, target_dir: str) -> None:
    base = load_state(base_dir)
    delta = load_state(delta_dir)
    target: StateDict = {}
    for name, dparam in delta.items():
        if name not in base:
            target[name] = dparam
            continue
        bparam = base[name]
        if dparam.shape == bparam.shape:
            target[name] = bparam + dparam
        else:
            assert name in EMBED_KEYS, f"{name} has unexpected shape change"
            t = dparam.to(torch.float32).clone()
            t[: bparam.shape[0], : bparam.shape[1]] += bparam.to(torch.float32)
            target[name] = t.to(dparam.dtype)
    _save_state(target, target_dir)
    _copy_config(delta_dir, target_dir)


def consolidate(src_dir: str, dst_dir: str) -> None:
    """Re-save all shards as one consolidated safetensors file
    (reference: consolidate.py:12-18)."""
    _save_state(load_state(src_dir), dst_dir)
    _copy_config(src_dir, dst_dir)


def merge_lora(
    base_dir: str,
    adapters_file: str,
    target_dir: str,
    *,
    lora_rank: int = 128,
    lora_alpha: float = 256.0,
) -> None:
    """Fold a trained ``adapters.safetensors`` (``Trainer.save_adapters``:
    leaf-path keys like ``lm/layers/q_proj/a``) into a base checkpoint — the
    analog of scripts/merge_lora_weights.py. Non-LoRA adapter keys
    (projectors, ``vcoder_lm_emb``) are assigned directly."""
    cfg, params = load_hf_checkpoint(base_dir, dtype=None, device="cpu")
    flat = read_safetensors(adapters_file)

    def node_at(path_parts):
        node = params
        for p in path_parts:
            node = node[int(p)] if p.isdigit() else node[p]
        return node

    def set_at(path_parts, value):
        node = params
        for p in path_parts[:-1]:
            node = node[int(p)] if p.isdigit() else node[p]
        last = path_parts[-1]
        node[int(last) if last.isdigit() else last] = value

    for key, arr in flat.items():
        parts = key.split("/")
        if parts[-1] == "a":
            b = flat[key[:-1] + "b"]
            w_path = parts[:-1]
            orig = node_at(w_path)
            dt = orig.dtype  # before the f32 upcast, or bf16 bases ship as f32
            w = orig.to(torch.float32)
            r = arr.shape[-1]
            if r != lora_rank:
                raise ValueError(
                    f"adapter {key!r} has rank {r} but --lora-rank is "
                    f"{lora_rank}: the alpha/rank scale would be wrong"
                )
            scale = float(lora_alpha) / r
            delta = scale * torch.einsum(
                "...ir,...ro->...io", arr.to(torch.float32), b.to(torch.float32)
            )
            set_at(w_path, (w + delta).to(dt))
        elif parts[-1] == "b":
            continue
        else:
            set_at(parts, arr.clone())

    save_pretrained(target_dir, params, cfg)
    # Tokenizer files only: save_pretrained already wrote the (possibly
    # normalized) config.json — clobbering it with the raw base copy would
    # silently undo any config upgrades.
    _copy_config(base_dir, target_dir, config=False)


def main():
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("make-delta")
    p.add_argument("--base", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--delta", required=True)
    p = sub.add_parser("apply-delta")
    p.add_argument("--base", required=True)
    p.add_argument("--delta", required=True)
    p.add_argument("--target", required=True)
    p = sub.add_parser("consolidate")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p = sub.add_parser("merge-lora")
    p.add_argument("--base", required=True)
    p.add_argument("--adapters", required=True)
    p.add_argument("--target", required=True)
    p.add_argument("--lora-rank", type=int, default=128)
    p.add_argument("--lora-alpha", type=float, default=256.0)
    args = parser.parse_args()

    if args.cmd == "make-delta":
        make_delta(args.base, args.target, args.delta)
    elif args.cmd == "apply-delta":
        apply_delta(args.base, args.delta, args.target)
    elif args.cmd == "consolidate":
        consolidate(args.src, args.dst)
    elif args.cmd == "merge-lora":
        merge_lora(
            args.base, args.adapters, args.target,
            lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
        )


if __name__ == "__main__":
    main()
