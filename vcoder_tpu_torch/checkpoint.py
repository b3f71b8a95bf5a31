"""Checkpoint interop (port of ``vcoder_tpu/checkpoint.py``).

HF-format checkpoint directories (``config.json`` + ``*.safetensors`` or
``pytorch_model*.bin``) <-> the port's layer-stacked parameter dicts:

* HF ``nn.Linear`` stores ``[out, in]``; the parameters store ``[in, out]``.
* Per-layer tensors are stacked along a leading ``num_layers`` axis.
* The CLIP patch-embedding Conv2d ``[D, C, P, P]`` flattens to ``[C*P*P, D]``
  (the flattening ``models/clip.py::patchify`` matches).

The safetensors format is read and written here (an 8-byte little-endian
header length, a JSON header, raw little-endian bytes), so no
``safetensors`` package is needed. ``from_jax_params`` turns the JAX
package's parameter tree, given as numpy arrays, into the port's parameters.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np
import torch

from vcoder_tpu_torch.config import TextConfig, VCoderConfig, VisionConfig, projector_depth
from vcoder_tpu_torch.device import resolve_device
from vcoder_tpu_torch.ops.quant import QuantizedTensor

StateDict = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------

_ST_DTYPES = {
    "BF16": torch.bfloat16,
    "F16": torch.float16,
    "F32": torch.float32,
    "F64": torch.float64,
    "I8": torch.int8,
    "U8": torch.uint8,
    "I16": torch.int16,
    "I32": torch.int32,
    "I64": torch.int64,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> StateDict:
    """Read a .safetensors file into CPU tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out: StateDict = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[meta["dtype"]]
        begin, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        numel = (end - begin) // torch.empty((), dtype=dtype).element_size()
        out[name] = torch.frombuffer(data, dtype=dtype, count=numel, offset=begin).reshape(shape)
    return out


def write_safetensors(path: str, state: StateDict) -> None:
    """Write CPU-copyable tensors to a .safetensors file."""
    header, blobs, offset = {}, [], 0
    for name in sorted(state):
        t = state[name].detach().to("cpu").contiguous()
        raw = t.view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {
            "dtype": _ST_NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + len(raw)],
        }
        blobs.append(raw)
        offset += len(raw)
    hdr = json.dumps(header, separators=(",", ":")).encode()
    hdr += b" " * (-len(hdr) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for raw in blobs:
            f.write(raw)


def load_state(model_dir: str) -> StateDict:
    """All weight shards of a checkpoint directory: *.safetensors, else the
    torch ``.bin`` shards (loaded with ``weights_only=True``)."""
    files = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
    state: StateDict = {}
    if files:
        for fname in files:
            state.update(read_safetensors(os.path.join(model_dir, fname)))
        return state
    skip = ("optimizer", "training_args", "trainer_state", "scheduler", "rng_state")
    bins = sorted(
        f for f in os.listdir(model_dir) if f.endswith(".bin") and not f.startswith(skip)
    )
    if not bins:
        raise FileNotFoundError(f"No .safetensors or .bin weight files in {model_dir}")
    for fname in bins:
        state.update(
            torch.load(os.path.join(model_dir, fname), map_location="cpu", weights_only=True)
        )
    return state


# ---------------------------------------------------------------------------
# Import (HF state dict -> parameters)
# ---------------------------------------------------------------------------


def _t(x: torch.Tensor) -> torch.Tensor:
    return x.t().contiguous()


def _stack(state: StateDict, fmt: str, n: int, transpose: bool) -> torch.Tensor:
    mats = [state[fmt.format(i=i)] for i in range(n)]
    return torch.stack([_t(m) if transpose else m for m in mats], dim=0)


def import_llama(state: StateDict, cfg: TextConfig, prefix: str = "model.") -> dict:
    p = prefix

    def lay(name, transpose=True):
        return _stack(state, p + "layers.{i}." + name, cfg.num_layers, transpose)

    return {
        "embed_tokens": state[p + "embed_tokens.weight"],
        "layers": {
            "input_layernorm": lay("input_layernorm.weight", transpose=False),
            "post_attention_layernorm": lay("post_attention_layernorm.weight", transpose=False),
            "q_proj": lay("self_attn.q_proj.weight"),
            "k_proj": lay("self_attn.k_proj.weight"),
            "v_proj": lay("self_attn.v_proj.weight"),
            "o_proj": lay("self_attn.o_proj.weight"),
            "gate_proj": lay("mlp.gate_proj.weight"),
            "up_proj": lay("mlp.up_proj.weight"),
            "down_proj": lay("mlp.down_proj.weight"),
        },
        "norm": state[p + "norm.weight"],
        "lm_head": _t(state["lm_head.weight"]),
    }


_CLIP_LAYER_MAP = [
    ("layer_norm1.weight", "ln1_scale", False),
    ("layer_norm1.bias", "ln1_bias", False),
    ("layer_norm2.weight", "ln2_scale", False),
    ("layer_norm2.bias", "ln2_bias", False),
    ("self_attn.q_proj.weight", "q_proj", True),
    ("self_attn.q_proj.bias", "q_bias", False),
    ("self_attn.k_proj.weight", "k_proj", True),
    ("self_attn.k_proj.bias", "k_bias", False),
    ("self_attn.v_proj.weight", "v_proj", True),
    ("self_attn.v_proj.bias", "v_bias", False),
    ("self_attn.out_proj.weight", "out_proj", True),
    ("self_attn.out_proj.bias", "out_bias", False),
    ("mlp.fc1.weight", "fc1", True),
    ("mlp.fc1.bias", "fc1_bias", False),
    ("mlp.fc2.weight", "fc2", True),
    ("mlp.fc2.bias", "fc2_bias", False),
]

_LLAMA_LAYER_MAP = [
    ("input_layernorm.weight", "input_layernorm", False),
    ("post_attention_layernorm.weight", "post_attention_layernorm", False),
    ("self_attn.q_proj.weight", "q_proj", True),
    ("self_attn.k_proj.weight", "k_proj", True),
    ("self_attn.v_proj.weight", "v_proj", True),
    ("self_attn.o_proj.weight", "o_proj", True),
    ("mlp.gate_proj.weight", "gate_proj", True),
    ("mlp.up_proj.weight", "up_proj", True),
    ("mlp.down_proj.weight", "down_proj", True),
]


def import_clip(state: StateDict, cfg: VisionConfig, prefix: str = "vision_model.") -> dict:
    """HF CLIPVisionModel state dict -> clip parameters (HF spells the
    pre-layernorm ``pre_layrnorm``)."""
    D, p = cfg.hidden_size, prefix
    conv = state[p + "embeddings.patch_embedding.weight"]  # [D, C, P, P]
    pre = p + "pre_layrnorm." if p + "pre_layrnorm.weight" in state else p + "pre_layernorm."
    return {
        "class_embedding": state[p + "embeddings.class_embedding"].reshape(D),
        "patch_embedding": _t(conv.reshape(D, -1)),
        "position_embedding": state[p + "embeddings.position_embedding.weight"],
        "pre_layernorm": {"scale": state[pre + "weight"], "bias": state[pre + "bias"]},
        "layers": {
            ours: _stack(state, p + "encoder.layers.{i}." + hf, cfg.num_layers, tr)
            for hf, ours, tr in _CLIP_LAYER_MAP
        },
    }


def import_projector(state: StateDict, prefix: str, projector_type: str = "mlp2x_gelu") -> dict:
    """HF Sequential(Linear, GELU, Linear, ...) (Linears at 0, 2, 4, ...) or a
    bare Linear -> projector parameters."""
    depth = projector_depth(projector_type)
    if depth == 0:
        return {"w": [], "b": []}
    if prefix + ".weight" in state:
        return {"w": [_t(state[prefix + ".weight"])], "b": [state[prefix + ".bias"]]}
    return {
        "w": [_t(state[f"{prefix}.{2 * i}.weight"]) for i in range(depth)],
        "b": [state[f"{prefix}.{2 * i}.bias"] for i in range(depth)],
    }


def import_vcoder(state: StateDict, cfg: VCoderConfig) -> dict:
    """Full VCoder/LLaVA checkpoint state dict -> parameters."""
    params = {
        "lm": import_llama(state, cfg.text, prefix="model."),
        "mm_projector": import_projector(state, "model.mm_projector", cfg.mm_projector_type),
    }
    for cand in (
        "model.vision_tower.vision_tower.vision_model.",
        "model.vision_tower.vision_model.",
        "vision_model.",
    ):
        if cand + "embeddings.class_embedding" in state:
            params["vision_tower"] = import_clip(state, cfg.vision, cand)
            break

    def _has_proj(prefix: str) -> bool:
        return f"{prefix}.0.weight" in state or f"{prefix}.weight" in state

    if cfg.use_mm2_proj and _has_proj("model.mm2_projector"):
        params["mm2_projector"] = import_projector(
            state, "model.mm2_projector", cfg.mm_projector_type
        )
    if cfg.use_seg and _has_proj("model.seg_mm_projector"):
        params["seg_projector"] = import_projector(
            state, "model.seg_mm_projector", cfg.seg_mm_projector_type
        )
    if cfg.use_depth and _has_proj("model.depth_mm_projector"):
        params["depth_projector"] = import_projector(
            state, "model.depth_mm_projector", cfg.depth_mm_projector_type
        )
    if cfg.use_vcoder_lm_emb:
        params["vcoder_lm_emb"] = state.get(
            "model.vcoder_lm_emb.weight", state["model.embed_tokens.weight"]
        )
    return params


# ---------------------------------------------------------------------------
# Export (parameters -> HF state dict)
# ---------------------------------------------------------------------------


def _unstack(out: StateDict, fmt: str, stacked: torch.Tensor, transpose: bool) -> None:
    for i in range(stacked.shape[0]):
        out[fmt.format(i=i)] = _t(stacked[i]) if transpose else stacked[i].contiguous()


def export_llama(params: dict, prefix: str = "model.") -> StateDict:
    out: StateDict = {
        prefix + "embed_tokens.weight": params["embed_tokens"],
        prefix + "norm.weight": params["norm"],
        "lm_head.weight": _t(params["lm_head"]),
    }
    for hf, ours, tr in _LLAMA_LAYER_MAP:
        _unstack(out, prefix + "layers.{i}." + hf, params["layers"][ours], tr)
    return out


def export_clip(params: dict, cfg: VisionConfig, prefix: str) -> StateDict:
    D, P, C = cfg.hidden_size, cfg.patch_size, cfg.num_channels
    out: StateDict = {
        prefix + "embeddings.class_embedding": params["class_embedding"],
        prefix + "embeddings.patch_embedding.weight": _t(params["patch_embedding"]).reshape(D, C, P, P),
        prefix + "embeddings.position_embedding.weight": params["position_embedding"],
        prefix + "pre_layrnorm.weight": params["pre_layernorm"]["scale"],
        prefix + "pre_layrnorm.bias": params["pre_layernorm"]["bias"],
    }
    for hf, ours, tr in _CLIP_LAYER_MAP:
        _unstack(out, prefix + "encoder.layers.{i}." + hf, params["layers"][ours], tr)
    return out


def export_projector(params: dict, prefix: str) -> StateDict:
    out: StateDict = {}
    for i, (w, b) in enumerate(zip(params["w"], params["b"])):
        out[f"{prefix}.{2 * i}.weight"] = _t(w)
        out[f"{prefix}.{2 * i}.bias"] = b
    return out


def export_vcoder(params: dict, cfg: VCoderConfig) -> StateDict:
    """Inverse of :func:`import_vcoder` (HF-layout state dict)."""
    state = export_llama(params["lm"], prefix="model.")
    state.update(export_projector(params["mm_projector"], "model.mm_projector"))
    if "vision_tower" in params:
        state.update(
            export_clip(
                params["vision_tower"], cfg.vision, "model.vision_tower.vision_tower.vision_model."
            )
        )
    for ours, hf in (
        ("mm2_projector", "model.mm2_projector"),
        ("seg_projector", "model.seg_mm_projector"),
        ("depth_projector", "model.depth_mm_projector"),
    ):
        if ours in params:
            state.update(export_projector(params[ours], hf))
    if "vcoder_lm_emb" in params:
        state["model.vcoder_lm_emb.weight"] = params["vcoder_lm_emb"]
    return state


def save_pretrained(model_dir: str, params: dict, cfg: VCoderConfig) -> None:
    """Write ``config.json`` + ``model.safetensors``, loadable by
    :func:`load_hf_checkpoint` and by the JAX package's loader."""
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg.to_hf_config(), f, indent=2)
    write_safetensors(os.path.join(model_dir, "model.safetensors"), export_vcoder(params, cfg))


def _map_tensors(tree, fn):
    """``fn`` over every tensor of a parameter tree, into quantized leaves
    (their ``q`` and ``scale``) too."""
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tensors(v, fn) for v in tree]
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(tree.q), fn(tree.scale), tree.bits)
    return fn(tree)


def load_hf_checkpoint(model_dir: str, *, dtype=torch.bfloat16, device="cuda"):
    """Load a local HF-format VCoder/LLaVA checkpoint directory onto
    ``device`` (``dtype=None`` keeps the stored dtypes). Returns
    (config, params)."""
    dev = resolve_device(device)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg = VCoderConfig.from_hf_config(json.load(f))
    params = import_vcoder(load_state(model_dir), cfg)
    params = _map_tensors(
        params, lambda t: t.to(device=dev, dtype=dtype if dtype is not None else t.dtype)
    )
    return cfg, params


def _is_quantized(leaf) -> bool:
    """A JAX ``QuantizedTensor`` leaf, matched by its name and fields: the
    port imports nothing of the JAX package."""
    return type(leaf).__name__ == "QuantizedTensor" and all(
        hasattr(leaf, f) for f in ("q", "scale", "bits")
    )


def from_jax_params(params_np, cfg: VCoderConfig, device="cuda") -> dict:
    """The JAX package's parameter tree (layer-stacked ``[L, in, out]``),
    given as numpy arrays, -> the port's parameters on ``device``. The two
    layouts are the same, so this converts leaf by leaf (bf16 arrays travel
    as their 16-bit patterns). A JAX ``QuantizedTensor`` leaf (its ``q`` and
    ``scale`` as numpy, its ``bits``) becomes the port's
    :class:`~vcoder_tpu_torch.ops.quant.QuantizedTensor` over the same bytes."""
    dev = resolve_device(device)
    q_proj = params_np["lm"]["layers"]["q_proj"]
    n_layers = np.shape(q_proj.q if _is_quantized(q_proj) else q_proj)[0]
    if n_layers != cfg.text.num_layers:
        raise ValueError(f"{n_layers} decoder layers, config says {cfg.text.num_layers}")

    def conv(a):
        if _is_quantized(a):
            return QuantizedTensor(conv(a.q), conv(a.scale), int(a.bits))
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return _map_tensors(params_np, conv)
