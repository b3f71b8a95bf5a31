"""The training step with stage-based trainable masks (port of
``vcoder_tpu/train/step.py:36-310``).

The reference trains in stages with most parameters frozen; the stage names
and their leaf patterns are the JAX package's (``STAGE_TRAINABLE``). The
trainable leaves get ``requires_grad_(True)`` and every other leaf stays out
of the graph, so the backward computes no weight gradient for the frozen
base and the optimizer state covers the trainable leaves alone.

The optimizer is the JAX package's optax chain written out in torch, update
for update: ``clip_by_global_norm(max_grad_norm)``, then AdamW (``b1``,
``b2``, ``eps=1e-8``, decoupled ``weight_decay``) on a linear-warmup cosine
schedule from 0 to ``lr`` and back to 0, then ``MultiSteps`` (the mean of
``accum_steps`` micro-batch gradients, Welford form) when ``accum_steps > 1``.
As in optax, the schedule is read at the update count *before* it is
incremented (the first update has lr 0), and the Adam moments keep each
parameter's dtype. ``torch.optim.AdamW`` orders these operations otherwise.

The step updates the trainable tensors IN PLACE (JAX returns new trees and
donates the old ones); the returned params are the same dictionary. The
opt-state offload of ``offload_shardings`` (the zero3_offload analog) is not
ported yet and raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Optional

import torch

from vcoder_tpu_torch.config import VCoderConfig
from vcoder_tpu_torch.models import vcoder as model_mod
from vcoder_tpu_torch.tree import named_leaves

STAGE_TRAINABLE = {
    "pretrain": [r"^mm_projector/"],
    "vcoder": [r"^seg_projector/", r"^vcoder_lm_emb$"],
    "vcoder_ds": [
        r"^seg_projector/",
        r"^depth_projector/",
        r"^vcoder_lm_emb$",
    ],
    "it": [r"^seg_projector/", r"^lm/", r"^mm_projector/"],
    "full": [r"^lm/", r"^mm_projector/"],
    "lora": [r"^lm/.*/(a|b)$", r"^mm_projector/"],
    "it_lora": [r"^lm/.*/(a|b)$", r"^seg_projector/", r"^mm_projector/"],
    "all": [r".*"],
}


def trainable_mask(params: dict, stage: str) -> Dict[str, bool]:
    """{leaf path: True where the stage trains the leaf}, over every tensor
    of ``params`` (paths as ``tree.named_leaves`` spells them)."""
    patterns = [re.compile(p) for p in STAGE_TRAINABLE[stage]]
    return {
        path: any(p.match(path) for p in patterns) for path, _ in named_leaves(params)
    }


def trainable_leaves(params: dict, stage: str) -> Dict[str, torch.Tensor]:
    """The stage's trainable tensors by path, in leaf order (the trainable
    half of JAX's ``partition``)."""
    mask = trainable_mask(params, stage)
    return {path: t for path, t in named_leaves(params) if mask[path]}


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax's
    ``global_norm``)."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW:
    """The JAX package's ``make_optimizer`` chain. State: a flat dict of
    tensors (``count``; ``mu/<path>``, ``nu/<path>``; with accumulation
    ``mini_step``, ``gradient_step`` and ``acc/<path>``), so a checkpoint is
    one safetensors file."""

    def __init__(
        self,
        lr: float,
        total_steps: int,
        *,
        warmup_ratio: float = 0.03,
        weight_decay: float = 0.0,
        b1: float = 0.9,
        b2: float = 0.999,
        max_grad_norm: Optional[float] = 1.0,
        accum_steps: int = 1,
    ):
        self.lr = lr
        self.warmup = max(int(total_steps * warmup_ratio), 1)
        self.decay_steps = max(total_steps, self.warmup + 1) - self.warmup
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, 1e-8  # optax.adamw's eps
        self.max_grad_norm = max_grad_norm
        self.accum_steps = accum_steps

    def schedule(self, count: int) -> torch.Tensor:
        """``warmup_cosine_decay_schedule(0, lr, warmup, decay, end 0)`` at
        ``count``, in f32 with optax's operation order."""
        f32 = torch.float32
        if count < self.warmup:
            frac = 1 - torch.tensor(count, dtype=f32) / self.warmup
            return (0.0 - self.lr) * frac + self.lr
        c = torch.tensor(min(float(count - self.warmup), float(self.decay_steps)), dtype=f32)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(self.decay_steps)))
        return self.lr * cosine  # optax's (1 - alpha) * cosine + alpha at alpha 0

    def init(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        dev = next(iter(leaves.values())).device if leaves else "cpu"
        state = {"count": torch.zeros((), dtype=torch.int32, device=dev)}
        for path, t in leaves.items():
            state[f"mu/{path}"] = torch.zeros_like(t)
            state[f"nu/{path}"] = torch.zeros_like(t)
        if self.accum_steps > 1:
            state["mini_step"] = torch.zeros((), dtype=torch.int32, device=dev)
            state["gradient_step"] = torch.zeros((), dtype=torch.int32, device=dev)
            for path, t in leaves.items():
                state[f"acc/{path}"] = torch.zeros_like(t)
        return state

    @torch.no_grad()
    def update(self, leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: Dict[str, torch.Tensor]) -> None:
        """One optimizer call on one micro-batch's gradients: parameters and
        state change in place."""
        if self.accum_steps > 1:
            n = int(state["mini_step"])
            for path, g in grads.items():
                acc = state[f"acc/{path}"]
                acc.add_((g - acc) / (n + 1))
            if n + 1 < self.accum_steps:
                state["mini_step"].fill_(n + 1)
                return
            grads = {path: state[f"acc/{path}"].clone() for path in grads}
            for path in grads:
                state[f"acc/{path}"].zero_()
            state["mini_step"].zero_()
            state["gradient_step"].add_(1)
        if self.max_grad_norm is not None:
            g_norm = global_norm(grads.values())
            if not bool(g_norm < self.max_grad_norm):
                grads = {p: (g / g_norm.to(g.dtype)) * self.max_grad_norm
                         for p, g in grads.items()}
        count = int(state["count"])
        step_size = -self.schedule(count)
        c = torch.tensor(count + 1, dtype=torch.float32)
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** c
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** c
        for path, p in leaves.items():
            g = grads[path]
            mu, nu = state[f"mu/{path}"], state[f"nu/{path}"]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p
            p.add_(step_size.to(device=u.device, dtype=u.dtype) * u)
        state["count"].add_(1)


def make_optimizer(
    lr: float,
    total_steps: int,
    *,
    warmup_ratio: float = 0.03,
    weight_decay: float = 0.0,
    b1: float = 0.9,
    b2: float = 0.999,
    max_grad_norm: Optional[float] = 1.0,
    accum_steps: int = 1,
) -> AdamW:
    """Cosine schedule with linear warmup AdamW, the reference recipe
    (``step.py:87``); ``total_steps`` counts optimizer updates."""
    return AdamW(lr, total_steps, warmup_ratio=warmup_ratio, weight_decay=weight_decay,
                 b1=b1, b2=b2, max_grad_norm=max_grad_norm, accum_steps=accum_steps)


def init_opt_state(params: dict, optimizer: AdamW, stage: str) -> Dict[str, torch.Tensor]:
    """Optimizer state over the trainable leaves only: no Adam moments for
    the frozen decoder."""
    return optimizer.init(trainable_leaves(params, stage))


def make_train_step(
    cfg: VCoderConfig,
    optimizer: AdamW,
    *,
    stage: str = "vcoder_ds",
    attn_impl: str = "auto",
    remat="dots",
    offload_shardings=None,
) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``batch`` holds the splice-plan tensors (``labels`` included) and
    optional ``images``/``segs``/``depths`` pixels. ``metrics``: ``loss``,
    ``grad_norm`` (of this micro-batch's raw gradients) and
    ``leaf_grad_norms`` (the same per trainable leaf, by path), as 0-d f32
    tensors on the device."""
    if offload_shardings is not None:
        raise NotImplementedError("opt-state offload is not ported yet")
    use_seg, use_depth = cfg.use_seg, cfg.use_depth

    def step(params, opt_state, batch):
        leaves = trainable_leaves(params, stage)
        for t in leaves.values():
            t.requires_grad_(True)
        loss = model_mod.train_forward(
            params,
            cfg,
            batch,
            batch.get("images"),
            batch.get("segs") if use_seg else None,
            batch.get("depths") if use_depth else None,
            use_vcoder_emb=cfg.use_vcoder_lm_emb and use_seg,
            attn_impl=attn_impl,
            remat=remat,
        )
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        # A leaf the loss does not reach (depth_projector: depth goes through
        # the seg projector) gets a zero gradient, as in JAX.
        grads = {
            path: torch.zeros_like(t) if g is None else g
            for (path, t), g in zip(leaves.items(), grads)
        }
        leaf_norms = {path: global_norm([g]) for path, g in grads.items()}
        gnorm = global_norm(grads.values())
        optimizer.update(leaves, grads, opt_state)
        return params, opt_state, {
            "loss": loss.detach(), "grad_norm": gnorm, "leaf_grad_norms": leaf_norms,
        }

    return step
