"""Plain PyTorch VCoder-DS, in float32 with TF32 off: the benchmark's
reference. It imports nothing of the program.

It reads the weights in the port's layout (``portbench/weights.py``):
stacked ``[L, in, out]`` matrices, ``x @ W``. The equations follow the
published models:

* CLIP ViT-L/14-336 (HF ``CLIPVisionModel``): patches flattened as a
  ``Conv2d`` weight is, ``(C, ph, pw)``; class token, position embeddings,
  the pre-LayerNorm; pre-norm blocks with biased q/k/v/out, 16 heads, and a
  quick-GELU MLP; the output of block ``num_layers + select_layer + 1``
  (select layer -2: 23 of 24 blocks), the class token dropped.
* Projectors ``mlp2x_gelu``: Linear, exact GELU, Linear.
* The VCoder-DS splice (``vcoder_ds_llava_arch.py``): text up to
  ``<image>``, the image block; the text before ``<seg>`` is dropped and the
  seg block placed; ``<depth>`` blocks where a ``<depth>`` is left; the
  rest as text. With a seg present the image goes through ``mm2_projector``,
  seg and depth through ``seg_projector``, and text embeds through
  ``vcoder_lm_emb``.
* The decoder (Mistral / DeepSeek-LLM, Llama-style): RMSNorm, rotate-half
  RoPE with ``rope_theta``, grouped-query causal attention, SwiGLU, the final
  norm and an untied head.

Each layer's weights are cast to float32 where they are used, so the model
never stands in float32 whole. ``mode="fp8"`` rounds both operands of every
linear layer to float8 e4m3 (a per-tensor scale, the gradient passed
straight through): the control, computed a precision below the bf16 the
configurations serve in.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils import checkpoint

IMAGE, SEG, DEPTH = -200, -300, -400
IGNORE = -100


def exact_math() -> None:
    """Float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


class Reference:
    """The model over weight tree ``w``; ``trainable`` maps a leaf path to
    the float32 tensor that stands in for it (the leaves a training step
    differentiates)."""

    def __init__(self, w: dict, d: dict, *, mode: str = "f32", trainable: Optional[dict] = None):
        if mode not in ("f32", "fp8"):
            raise ValueError(mode)
        self.w, self.d, self.mode = w, d, mode
        self.trainable = trainable or {}

    # -- leaves --

    def leaf(self, path: str) -> torch.Tensor:
        if path in self.trainable:
            return self.trainable[path]
        node = self.w
        for k in path.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        return node.float()

    def lin(self, x, wt, b=None):
        if self.mode == "fp8":
            x, wt = _fp8(x), _fp8(wt)
        y = x @ wt
        return y if b is None else y + b

    # -- vision --

    @torch.no_grad()
    def tower(self, px: torch.Tensor) -> torch.Tensor:
        """[N, S, S, 3] pixels -> [N, n_patches, Dv] features."""
        d = self.d
        N, S, _, C = px.shape
        P, Dv, Hv = d["patch"], d["Dv"], d["Hv"]
        g = S // P
        x = px.float().reshape(N, g, P, g, P, C).permute(0, 1, 3, 5, 2, 4).reshape(N, g * g, C * P * P)
        t = "vision_tower"
        x = x @ self.leaf(f"{t}/patch_embedding")
        cls = self.leaf(f"{t}/class_embedding").expand(N, 1, Dv)
        x = torch.cat([cls, x], dim=1) + self.leaf(f"{t}/position_embedding")[None]
        x = F.layer_norm(x, (Dv,), self.leaf(f"{t}/pre_layernorm/scale"),
                         self.leaf(f"{t}/pre_layernorm/bias"), d["veps"])
        lw = self.w[t]["layers"]
        T = x.shape[1]
        hd = Dv // Hv
        for l in range(d["tower_blocks"]):
            p = {k: v[l].float() for k, v in lw.items()}
            h = F.layer_norm(x, (Dv,), p["ln1_scale"], p["ln1_bias"], d["veps"])
            q = (h @ p["q_proj"] + p["q_bias"]).reshape(N, T, Hv, hd).transpose(1, 2)
            k = (h @ p["k_proj"] + p["k_bias"]).reshape(N, T, Hv, hd).transpose(1, 2)
            v = (h @ p["v_proj"] + p["v_bias"]).reshape(N, T, Hv, hd).transpose(1, 2)
            a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1) @ v
            x = x + (a.transpose(1, 2).reshape(N, T, Dv) @ p["out_proj"] + p["out_bias"])
            h = F.layer_norm(x, (Dv,), p["ln2_scale"], p["ln2_bias"], d["veps"])
            h = h @ p["fc1"] + p["fc1_bias"]
            x = x + ((h * torch.sigmoid(1.702 * h)) @ p["fc2"] + p["fc2_bias"])
        return x[:, 1:]

    def project(self, name: str, x: torch.Tensor) -> torch.Tensor:
        x = self.lin(x, self.leaf(f"{name}/w/0"), self.leaf(f"{name}/b/0"))
        return self.lin(F.gelu(x), self.leaf(f"{name}/w/1"), self.leaf(f"{name}/b/1"))

    # -- the splice --

    def embed(self, ids: Sequence[int], pictures: torch.Tensor,
              labels: Optional[Sequence[int]] = None):
        """One row: (embeddings [n, D], labels [n] or None). ``pictures`` is
        the row's [3, S, S, 3] stack (image, seg, depth)."""
        feats = {}

        def block(kind):
            if kind not in feats:
                i = {"image": 0, "seg": 1, "depth": 2}[kind]
                f = self.tower(pictures[i:i + 1])[0]
                feats[kind] = self.project("mm2_projector" if kind == "image" else "seg_projector", f)
            return feats[kind]

        table = self.leaf("vcoder_lm_emb")
        parts, labs = [], []
        cur = list(ids)
        cl = list(labels) if labels is not None else [IGNORE] * len(cur)

        def text(n):
            if n:
                parts.append(table[torch.as_tensor(cur[:n], device=table.device)])
                labs.extend(cl[:n])

        def vision(kind):
            f = block(kind)
            parts.append(f)
            labs.extend([IGNORE] * f.shape[0])

        for sentinel, kind, keep_text in ((IMAGE, "image", True), (SEG, "seg", False),
                                          (DEPTH, "depth", True)):
            while sentinel in cur:
                i = cur.index(sentinel)
                if keep_text:
                    text(i)
                vision(kind)
                cur, cl = cur[i + 1:], cl[i + 1:]
        text(len(cur))
        x = torch.cat(parts, dim=0)
        return x, (torch.as_tensor(labs, device=x.device) if labels is not None else None)

    # -- the decoder --

    def _layer(self, x: torch.Tensor, l: int) -> torch.Tensor:
        d = self.d
        n = x.shape[0]
        H, KH, HD = d["H"], d["KH"], d["HD"]
        p = {k: v[l].float() for k, v in self.w["lm"]["layers"].items()}

        def rms(t, wt):
            return t * torch.rsqrt(t.pow(2).mean(-1, keepdim=True) + d["eps"]) * wt

        pos = torch.arange(n, device=x.device, dtype=torch.float32)
        inv = 1.0 / d["theta"] ** (torch.arange(0, HD, 2, device=x.device, dtype=torch.float32) / HD)
        ang = torch.cat([pos[:, None] * inv] * 2, dim=-1)
        cos, sin = ang.cos()[:, None], ang.sin()[:, None]

        def rope(t):
            half = t.shape[-1] // 2
            return t * cos + torch.cat([-t[..., half:], t[..., :half]], dim=-1) * sin

        h = rms(x, p["input_layernorm"])
        q = rope(self.lin(h, p["q_proj"]).reshape(n, H, HD))
        k = rope(self.lin(h, p["k_proj"]).reshape(n, KH, HD))
        v = self.lin(h, p["v_proj"]).reshape(n, KH, HD)
        k = k.repeat_interleave(H // KH, dim=1)
        v = v.repeat_interleave(H // KH, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(HD)
        s = s.masked_fill(torch.ones(n, n, dtype=torch.bool, device=x.device).triu(1), float("-inf"))
        a = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v).reshape(n, H * HD)
        x = x + self.lin(a, p["o_proj"])
        h = rms(x, p["post_attention_layernorm"])
        return x + self.lin(F.silu(self.lin(h, p["gate_proj"])) * self.lin(h, p["up_proj"]),
                            p["down_proj"])

    def decode(self, xs: List[torch.Tensor], remat: bool = False) -> List[torch.Tensor]:
        """Every layer over each row; a layer's weights are cast once for all
        rows unless ``remat`` (training: each row's layer checkpointed)."""
        for l in range(self.d["L"]):
            if remat:
                xs = [checkpoint.checkpoint(self._layer, x, l, use_reentrant=False) for x in xs]
            else:
                xs = [self._layer(x, l) for x in xs]
        return xs

    def head(self, x: torch.Tensor) -> torch.Tensor:
        d = self.d
        x = x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + d["eps"]) * self.leaf("lm/norm")
        return self.lin(x, self.leaf("lm/lm_head"))


def served_logits(ref: Reference, rows) -> List[torch.Tensor]:
    """For each (prompt ids, served tokens, pictures): the reference's
    logits [len(served), V] at the positions that predict each served token
    (the prompt's last, then each served token but the last)."""
    with torch.no_grad():
        xs, starts = [], []
        for ids, served, px in rows:
            x, _ = ref.embed(ids, px)
            starts.append(x.shape[0] - 1)
            if len(served) > 1:
                # Decode steps embed through the LM's own table, as the
                # published generate does for one new token.
                t = ref.leaf("lm/embed_tokens")[torch.as_tensor(served[:-1], device=x.device)]
                x = torch.cat([x, t], dim=0)
            xs.append(x)
        hs = ref.decode(xs)
        return [ref.head(h[s:]) for h, s in zip(hs, starts)]


def loss(ref: Reference, rows) -> torch.Tensor:
    """Shifted cross-entropy over the labelled positions of a batch of
    (ids, labels, pictures) rows, the mean over all of them."""
    xs, labs = [], []
    for ids, labels, px in rows:
        x, lab = ref.embed(ids, px, labels)
        xs.append(x)
        labs.append(lab)
    hs = ref.decode(xs, remat=True)
    total = torch.zeros((), device=hs[0].device)
    count = 0
    for h, lab in zip(hs, labs):
        tgt = lab[1:]
        keep = tgt != IGNORE
        logits = ref.head(h[:-1][keep])
        total = total + F.cross_entropy(logits, tgt[keep], reduction="sum")
        count += int(keep.sum())
    return total / max(count, 1)
