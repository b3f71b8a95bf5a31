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

Checkpoints over a base (``vcoder_tpu/checkpoint.py:448,533``):
:func:`load_lora_checkpoint` merges a PEFT LoRA directory into its base
(with the ``non_lora_trainables.bin`` overlay), and ``load_hf_checkpoint``
takes a ``state_overlay`` and a ``config_dir`` for an adapter-only
directory over a base.
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
from vcoder_tpu_torch.lora import LoraWeight, MultiLoraWeight
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
    """Read a .safetensors file into CPU tensors. The data is read once,
    into one buffer the tensors view (a 13B checkpoint is 25 GiB: the host
    holds it once, not twice)."""
    with open(path, "rb", buffering=0) as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        view, got = memoryview(data), 0
        while got < len(data):
            k = f.readinto(view[got:])
            if not k:
                raise ValueError(f"{path}: file ended {len(data) - got} bytes early")
            got += k
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
    """Write CPU-copyable tensors to a .safetensors file. The header comes
    from the shapes and dtypes alone; then each tensor is copied to the host
    and written in turn, so the host holds one tensor's bytes at a time.

    With DTensors among the tensors (a tree sharded over a distributed mesh)
    every rank of the group must call this: each DTensor is gathered in turn
    and rank 0 alone writes it, so no rank holds more than one whole tensor;
    the call returns on every rank once the file is complete."""
    from torch.distributed.tensor import DTensor

    sharded = any(isinstance(t, DTensor) for t in state.values())
    if sharded:
        import torch.distributed as dist

        if dist.get_rank() != 0:
            for name in sorted(state):
                if isinstance(state[name], DTensor):
                    state[name].detach().full_tensor()
            dist.barrier()
            return
    names = sorted(state)
    header, offset = {}, 0
    for name in names:
        t = state[name]
        n = t.numel() * t.element_size()
        header[name] = {
            "dtype": _ST_NAMES[t.dtype],
            "shape": list(t.shape),
            "data_offsets": [offset, offset + n],
        }
        offset += n
    hdr = json.dumps(header, separators=(",", ":")).encode()
    hdr += b" " * (-len(hdr) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for name in names:
            t = state[name].detach()
            if isinstance(t, DTensor):
                t = t.full_tensor()
            if t.numel():
                f.write(t.to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy())
    if sharded:
        dist.barrier()


def load_state(model_dir: str) -> StateDict:
    """All weight shards of a checkpoint directory (``load_safetensors_state
    :215``): *.safetensors, else the torch ``.bin`` shards (loaded with
    ``weights_only=True``)."""
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


def auto_upgrade(model_dir: str, assume_yes: bool = False) -> None:
    """Upgrade a v0-era checkpoint whose config still says ``model_type:
    llama`` to ``llava`` (``vcoder_tpu/checkpoint.py:273-302``; reference:
    vcoder_llava/model/utils.py:4-20). Rewrites config.json in place."""
    cfg_path = os.path.join(model_dir, "config.json")
    with open(cfg_path) as f:
        hf = json.load(f)
    if "llava" in model_dir and "llava" not in hf.get("model_type", ""):
        assert hf.get("model_type") == "llama", hf.get("model_type")
        print(
            "You are using newer LLaVA code base, while the checkpoint of"
            " v0 is from older code base."
        )
        if not assume_yes:
            confirm = input("Please confirm that you want to upgrade the checkpoint. [Y/N]")
            if confirm.lower() not in ("y", "yes"):
                raise SystemExit("Checkpoint upgrade aborted.")
        hf["model_type"] = "llava"
        hf["architectures"] = ["LlavaLlamaForCausalLM"]
        with open(cfg_path, "w") as f:
            json.dump(hf, f, indent=2)
        print("Checkpoint upgraded.")


# ---------------------------------------------------------------------------
# Import (HF state dict -> parameters)
# ---------------------------------------------------------------------------


def _t(x: torch.Tensor, device=None) -> torch.Tensor:
    """``x`` transposed into a new contiguous tensor; with ``device``, ``x``
    is moved there first and transposed there."""
    return x.to(device).t().contiguous()


def _stack(state: StateDict, fmt: str, n: int, transpose: bool, device=None) -> torch.Tensor:
    """The ``n`` layers' tensors stacked on a new axis 0 (each matrix
    transposed when asked), copied once into one tensor on ``device`` (the
    state's by default): each layer is moved as stored, then transposed in
    place there, so a load onto the card transposes on the card."""
    mats = [state[fmt.format(i=i)] for i in range(n)]
    shape = tuple(mats[0].shape)[::-1] if transpose else tuple(mats[0].shape)
    out = torch.empty((n,) + shape, dtype=mats[0].dtype,
                      device=mats[0].device if device is None else device)
    for i, m in enumerate(mats):
        m = m.to(out.device)
        out[i].copy_(m.t() if transpose else m)
    return out


def import_llama(state: StateDict, cfg: TextConfig, prefix: str = "model.", device=None) -> dict:
    p = prefix

    def lay(name, transpose=True):
        return _stack(state, p + "layers.{i}." + name, cfg.num_layers, transpose, device)

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
        "lm_head": _t(state["lm_head.weight"], device),
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


def import_clip(state: StateDict, cfg: VisionConfig, prefix: str = "vision_model.",
                device=None) -> dict:
    """HF CLIPVisionModel state dict -> clip parameters (HF spells the
    pre-layernorm ``pre_layrnorm``)."""
    D, p = cfg.hidden_size, prefix
    conv = state[p + "embeddings.patch_embedding.weight"]  # [D, C, P, P]
    pre = p + "pre_layrnorm." if p + "pre_layrnorm.weight" in state else p + "pre_layernorm."
    return {
        "class_embedding": state[p + "embeddings.class_embedding"].reshape(D),
        "patch_embedding": _t(conv.reshape(D, -1), device),
        "position_embedding": state[p + "embeddings.position_embedding.weight"],
        "pre_layernorm": {"scale": state[pre + "weight"], "bias": state[pre + "bias"]},
        "layers": {
            ours: _stack(state, p + "encoder.layers.{i}." + hf, cfg.num_layers, tr, device)
            for hf, ours, tr in _CLIP_LAYER_MAP
        },
    }


def import_projector(state: StateDict, prefix: str, projector_type: str = "mlp2x_gelu",
                     device=None) -> dict:
    """HF Sequential(Linear, GELU, Linear, ...) (Linears at 0, 2, 4, ...) or a
    bare Linear -> projector parameters."""
    depth = projector_depth(projector_type)
    if depth == 0:
        return {"w": [], "b": []}
    if prefix + ".weight" in state:
        return {"w": [_t(state[prefix + ".weight"], device)], "b": [state[prefix + ".bias"]]}
    return {
        "w": [_t(state[f"{prefix}.{2 * i}.weight"], device) for i in range(depth)],
        "b": [state[f"{prefix}.{2 * i}.bias"] for i in range(depth)],
    }


def import_vcoder(state: StateDict, cfg: VCoderConfig, device=None) -> dict:
    """Full VCoder/LLaVA checkpoint state dict -> parameters. With
    ``device``, the transposed and stacked leaves are made there (the other
    leaves stay where the state holds them)."""
    params = {
        "lm": import_llama(state, cfg.text, prefix="model.", device=device),
        "mm_projector": import_projector(state, "model.mm_projector", cfg.mm_projector_type,
                                         device),
    }
    for cand in (
        "model.vision_tower.vision_tower.vision_model.",
        "model.vision_tower.vision_model.",
        "vision_model.",
    ):
        if cand + "embeddings.class_embedding" in state:
            params["vision_tower"] = import_clip(state, cfg.vision, cand, device)
            break

    def _has_proj(prefix: str) -> bool:
        return f"{prefix}.0.weight" in state or f"{prefix}.weight" in state

    if cfg.use_mm2_proj and _has_proj("model.mm2_projector"):
        params["mm2_projector"] = import_projector(
            state, "model.mm2_projector", cfg.mm_projector_type, device
        )
    if cfg.use_seg and _has_proj("model.seg_mm_projector"):
        params["seg_projector"] = import_projector(
            state, "model.seg_mm_projector", cfg.seg_mm_projector_type, device
        )
    if cfg.use_depth and _has_proj("model.depth_mm_projector"):
        params["depth_projector"] = import_projector(
            state, "model.depth_mm_projector", cfg.depth_mm_projector_type, device
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
    from torch.distributed.tensor import DTensor

    D, P, C = cfg.hidden_size, cfg.patch_size, cfg.num_channels
    patch = params["patch_embedding"]
    if isinstance(patch, DTensor):  # a sharded tree being written: DTensor has no such view
        patch = patch.full_tensor()
    out: StateDict = {
        prefix + "embeddings.class_embedding": params["class_embedding"],
        prefix + "embeddings.patch_embedding.weight": _t(patch).reshape(D, C, P, P),
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
    :func:`load_hf_checkpoint` and by the JAX package's loader. A tree
    sharded over a distributed mesh is written by rank 0, leaf by leaf
    (:func:`write_safetensors`); every rank calls this."""
    from vcoder_tpu_torch.parallel.mesh import rank_zero

    if rank_zero():
        os.makedirs(model_dir, exist_ok=True)
        with open(os.path.join(model_dir, "config.json"), "w") as f:
            json.dump(cfg.to_hf_config(), f, indent=2)
    write_safetensors(os.path.join(model_dir, "model.safetensors"), export_vcoder(params, cfg))


def _map_tensors(tree, fn):
    """``fn`` over every tensor of a parameter tree, into quantized leaves
    (their ``q`` and ``scale``) and LoRA wrappers too."""
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tensors(v, fn) for v in tree]
    if isinstance(tree, QuantizedTensor):
        return QuantizedTensor(fn(tree.q), fn(tree.scale), tree.bits)
    if isinstance(tree, LoraWeight):
        return LoraWeight(_map_tensors(tree.base, fn), fn(tree.a), fn(tree.b), tree.scale)
    if isinstance(tree, MultiLoraWeight):
        return MultiLoraWeight(_map_tensors(tree.base, fn), fn(tree.a), fn(tree.b), fn(tree.idx))
    return fn(tree)


def _place(params, dtype, dev, place=None, prefix: str = ""):
    """Every leaf on ``dev`` in ``dtype``; with ``place(path, leaf)`` (over a
    mesh, ``parallel.leaf_sharder``) each leaf goes through it as soon as it
    is on ``dev``, before the next one is moved."""
    def put(t):
        return t.to(device=dev, dtype=dtype if dtype is not None else t.dtype)

    if place is None:
        return _map_tensors(params, put)
    if isinstance(params, dict):
        return {k: _place(v, dtype, dev, place, f"{prefix}/{k}" if prefix else k)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_place(v, dtype, dev, place, f"{prefix}/{i}") for i, v in enumerate(params)]
    return place(prefix, put(params))


def _import_for(state: StateDict, cfg: VCoderConfig, dev, place):
    """:func:`import_vcoder` for a load onto ``dev``: the stacked and
    transposed leaves are made on ``dev`` directly (each layer moved as
    stored, transposed there), unless ``place`` shards each leaf as it
    arrives, which needs one whole leaf on the device at a time."""
    return import_vcoder(state, cfg, device=dev if place is None else None)


def _read_config(model_dir: str) -> VCoderConfig:
    with open(os.path.join(model_dir, "config.json")) as f:
        return VCoderConfig.from_hf_config(json.load(f))


def load_hf_checkpoint(model_dir: str, *, dtype=torch.bfloat16, device="cuda",
                       state_overlay: StateDict = None, config_dir: str = None, place=None):
    """Load a local HF-format VCoder/LLaVA checkpoint directory onto
    ``device`` (``dtype=None`` keeps the stored dtypes). ``state_overlay``
    entries replace the loaded state before import (an adapter over a base);
    ``config_dir`` reads config.json from another directory; ``place``: see
    :func:`_place`. Returns (config, params)."""
    dev = resolve_device(device)
    cfg = _read_config(config_dir or model_dir)
    state = load_state(model_dir)
    if state_overlay:
        state.update(state_overlay)
    return cfg, _place(_import_for(state, cfg, dev, place), dtype, dev, place)


def load_lora_checkpoint(model_path: str, model_base: str, *, dtype=torch.bfloat16,
                         device="cuda", place=None):
    """A PEFT-format LoRA checkpoint directory over a base, merged (the
    reference's LoRA path, model/builder.py:44-81): the base's weights, the
    ``non_lora_trainables.bin`` overlay with its prefix rules, then
    ``W += scale * B @ A`` in HF's ``[out, in]`` layout, in f32, rounded to
    the stored dtype. Returns (config, params)."""
    from vcoder_tpu_torch.lora import adapter_scale, read_adapter_config, read_adapter_state

    dev = resolve_device(device)
    cfg = _read_config(model_path)
    state = load_state(model_base)
    # Non-LoRA trainables: projectors, vcoder_lm_emb, embeddings.
    nlt_path = os.path.join(model_path, "non_lora_trainables.bin")
    if os.path.exists(nlt_path):
        non_lora = torch.load(nlt_path, map_location="cpu", weights_only=True)
        non_lora = {(k[11:] if k.startswith("base_model.") else k): v for k, v in non_lora.items()}
        # The reference (model/builder.py:60-63): if ANY key starts with
        # 'model.model.', strip 'model.' from EVERY 'model.'-prefixed key,
        # 'model.lm_head.weight' included.
        if any(k.startswith("model.model.") for k in non_lora):
            non_lora = {(k[6:] if k.startswith("model.") else k): v for k, v in non_lora.items()}
        state.update(non_lora)
    scale = adapter_scale(read_adapter_config(model_path))
    adapters = read_adapter_state(model_path)
    for key, a in adapters.items():
        if ".lora_A." not in key:
            continue
        b = adapters[key.replace(".lora_A.", ".lora_B.")]
        w_name = key.replace("base_model.model.", "").replace(".lora_A.weight", ".weight")
        if w_name not in state:
            raise KeyError(f"LoRA target {w_name} missing from base")
        w = state[w_name]
        delta = scale * (b.float() @ a.float())  # [out, r] @ [r, in]
        state[w_name] = (w.float() + delta).to(w.dtype)
    return cfg, _place(_import_for(state, cfg, dev, place), dtype, dev, place)


def _is_jax_leaf(leaf, name: str, fields) -> bool:
    """A JAX wrapper leaf (``QuantizedTensor``, ``LoraWeight``,
    ``MultiLoraWeight``), matched by its name and fields: the port imports
    nothing of the JAX package."""
    return type(leaf).__name__ == name and all(hasattr(leaf, f) for f in fields)


def _is_quantized(leaf) -> bool:
    return _is_jax_leaf(leaf, "QuantizedTensor", ("q", "scale", "bits"))


def from_jax_params(params_np, cfg: VCoderConfig, device="cuda") -> dict:
    """The JAX package's parameter tree (layer-stacked ``[L, in, out]``),
    given as numpy arrays, -> the port's parameters on ``device``. The two
    layouts are the same, so this converts leaf by leaf (bf16 arrays travel
    as their 16-bit patterns). A JAX ``QuantizedTensor`` leaf (its ``q`` and
    ``scale`` as numpy, its ``bits``) becomes the port's
    :class:`~vcoder_tpu_torch.ops.quant.QuantizedTensor` over the same bytes,
    and a JAX ``LoraWeight`` / ``MultiLoraWeight`` the port's
    (``vcoder_tpu_torch/lora.py``) over converted fields."""
    dev = resolve_device(device)
    q_proj = params_np["lm"]["layers"]["q_proj"]
    n_layers = q_proj.shape[0]
    if n_layers != cfg.text.num_layers:
        raise ValueError(f"{n_layers} decoder layers, config says {cfg.text.num_layers}")

    def conv(a):
        if _is_quantized(a):
            return QuantizedTensor(conv(a.q), conv(a.scale), int(a.bits))
        if _is_jax_leaf(a, "LoraWeight", ("base", "a", "b", "scale")):
            return LoraWeight(conv(a.base), conv(a.a), conv(a.b), float(a.scale))
        if _is_jax_leaf(a, "MultiLoraWeight", ("base", "a", "b", "idx")):
            return MultiLoraWeight(conv(a.base), conv(a.a), conv(a.b), conv(a.idx))
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return _map_tensors(params_np, conv)
