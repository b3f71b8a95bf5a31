"""Seeded weights in the port's parameter layout, made on the device.

The benchmark makes the weights itself (they are inputs, handed to the
program and, made again from the same seed, to the reference): matrices
``N(0, 0.02)``, norm scales ``1 + N(0, 0.02)``, biases ``N(0, 0.02)``, all
in bf16, drawn by one ``torch.Generator`` on the device in one call per
group. The layout is the port's (``models/llama.py``, ``models/clip.py``,
``models/projectors.py``): stacked ``[L, in, out]`` matrices, ``x @ W``.
The frozen leaves are views of one buffer; the trainable ones (the
VCoder-DS stage-3 adapters) are tensors of their own.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from portbench import spec

TRAINABLE = ("seg_projector", "depth_projector", "vcoder_lm_emb")


def layout(d: dict) -> List[Tuple[str, tuple, str]]:
    """(path, shape, kind) of every leaf but ``vcoder_lm_emb`` (a copy of
    the embedding table); kind is ``w``, ``scale`` or ``bias``."""
    L, D, I, V = d["L"], d["D"], d["I"], d["V"]
    H, KH, HD = d["H"], d["KH"], d["HD"]
    Lv, Dv, Iv, P = d["Lv"], d["Dv"], d["Iv"], d["patch"]
    out = [("lm/embed_tokens", (V, D), "w")]
    for k, shape, kind in (
        ("input_layernorm", (L, D), "scale"), ("post_attention_layernorm", (L, D), "scale"),
        ("q_proj", (L, D, H * HD), "w"), ("k_proj", (L, D, KH * HD), "w"),
        ("v_proj", (L, D, KH * HD), "w"), ("o_proj", (L, H * HD, D), "w"),
        ("gate_proj", (L, D, I), "w"), ("up_proj", (L, D, I), "w"),
        ("down_proj", (L, I, D), "w"),
    ):
        out.append((f"lm/layers/{k}", shape, kind))
    out += [("lm/norm", (D,), "scale"), ("lm/lm_head", (D, V), "w")]
    t = "vision_tower"
    out += [(f"{t}/class_embedding", (Dv,), "w"), (f"{t}/patch_embedding", (P * P * 3, Dv), "w"),
            (f"{t}/position_embedding", (d["n_patches"] + 1, Dv), "w"),
            (f"{t}/pre_layernorm/scale", (Dv,), "scale"), (f"{t}/pre_layernorm/bias", (Dv,), "bias")]
    for k, shape, kind in (
        ("ln1_scale", (Lv, Dv), "scale"), ("ln1_bias", (Lv, Dv), "bias"),
        ("ln2_scale", (Lv, Dv), "scale"), ("ln2_bias", (Lv, Dv), "bias"),
        ("q_proj", (Lv, Dv, Dv), "w"), ("q_bias", (Lv, Dv), "bias"),
        ("k_proj", (Lv, Dv, Dv), "w"), ("k_bias", (Lv, Dv), "bias"),
        ("v_proj", (Lv, Dv, Dv), "w"), ("v_bias", (Lv, Dv), "bias"),
        ("out_proj", (Lv, Dv, Dv), "w"), ("out_bias", (Lv, Dv), "bias"),
        ("fc1", (Lv, Dv, Iv), "w"), ("fc1_bias", (Lv, Iv), "bias"),
        ("fc2", (Lv, Iv, Dv), "w"), ("fc2_bias", (Lv, Dv), "bias"),
    ):
        out.append((f"{t}/layers/{k}", shape, kind))
    for proj in ("mm_projector", "mm2_projector", "seg_projector", "depth_projector"):
        out += [(f"{proj}/w/0", (Dv, D), "w"), (f"{proj}/b/0", (D,), "bias"),
                (f"{proj}/w/1", (D, D), "w"), (f"{proj}/b/1", (D,), "bias")]
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _put(tree: dict, path: str, t: torch.Tensor) -> None:
    keys = path.split("/")
    node = tree
    for i, k in enumerate(keys[:-1]):
        nxt = keys[i + 1]
        if k not in node:
            node[k] = [] if nxt.isdigit() else {}
        node = node[k]
    last = keys[-1]
    if isinstance(node, list):
        node.append(t)
    else:
        node[last] = t


def make(d: dict, seed: int, device) -> dict:
    """The whole tree for configuration dims ``d`` from ``seed``, in the
    configuration's ``torch_dtype``."""
    dtype = getattr(torch, d["dtype"])
    leaves = layout(d)
    gen = torch.Generator(device=device)
    gen.manual_seed(spec.torch_seed(seed, "weights"))
    tree: dict = {}
    for group in (False, True):  # the frozen buffer, then the trainable one
        mine = [e for e in leaves if (e[0].split("/")[0] in TRAINABLE) == group]
        buf = torch.empty(sum(_numel(s) for _, s, _ in mine), dtype=dtype, device=device)
        buf.normal_(0.0, 1.0, generator=gen)
        off = 0
        for path, shape, kind in mine:
            n = _numel(shape)
            t = buf[off:off + n].view(shape)
            off += n
            t.mul_(0.02)
            if kind == "scale":
                t.add_(1.0)
            _put(tree, path, t.clone() if group else t)
        del buf
    tree["vcoder_lm_emb"] = tree["lm"]["embed_tokens"].clone()
    return tree


def trainable_paths(tree: dict) -> List[str]:
    """Paths of the stage-3 leaves, as the port's ``named_leaves`` spells them."""
    out = []
    for top in TRAINABLE:
        node = tree[top]
        if isinstance(node, torch.Tensor):
            out.append(top)
        else:
            out += [f"{top}/{k}/{i}" for k in ("w", "b") for i in range(len(node[k]))]
    return out


def leaf(tree: dict, path: str) -> torch.Tensor:
    node = tree
    for k in path.split("/"):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node
