"""The stage-3 training recipe in plain PyTorch, float32: the reference's
loss, gradients and AdamW updates over the first steps of a run.

The recipe is VCoder's (``scripts/v1_5/vcoder_ds_train.sh``, HF
``Trainer``): clip the gradients to a global norm of ``max_grad_norm``,
then AdamW (``B1``, ``B2``, ``EPS``: the recipe's, which are also the
constants of the program's AdamW; no weight decay) on a schedule
that rises linearly from 0 over ``warmup`` updates and falls on a cosine to
0 at ``total`` updates; the n-th update (from 0) uses the rate at n.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference.model import Reference, loss

# AdamW's constants in the recipe (HF ``Trainer``'s defaults). The harness
# reads the program's first gradient back from its first moment with B1.
B1, B2, EPS = 0.9, 0.999, 1e-8


def learning_rate(n: int, lr: float, total: int, warmup_ratio: float) -> float:
    warmup = max(int(total * warmup_ratio), 1)
    if n < warmup:
        return lr * n / warmup
    decay = max(total, warmup + 1) - warmup
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(n - warmup, decay) / decay))


def run_steps(w: dict, d: dict, paths: List[str], batches, recipe: dict, *,
              mode: str = "f32") -> Dict[str, object]:
    """``batches``: a list of steps, each a list of (ids, labels, pictures)
    rows. Returns the loss of each step, the gradient of each leaf as the
    update of the first step takes it (after clipping), and each leaf's
    change after all the steps."""
    start = {p: _leaf(w, p).float() for p in paths}
    params = {p: t.clone().requires_grad_(True) for p, t in start.items()}
    mu = {p: torch.zeros_like(t) for p, t in start.items()}
    nu = {p: torch.zeros_like(t) for p, t in start.items()}
    b1, b2, eps = B1, B2, EPS
    losses, first = [], None
    for n, rows in enumerate(batches):
        ref = Reference(w, d, mode=mode, trainable=params)
        value = loss(ref, rows)
        grads = torch.autograd.grad(value, list(params.values()), allow_unused=True)
        g = {p: torch.zeros_like(params[p]) if gr is None else gr.detach()
             for p, gr in zip(params, grads)}
        losses.append(float(value.detach()))
        norm = math.sqrt(sum(float(t.double().pow(2).sum()) for t in g.values()))
        if recipe["max_grad_norm"] is not None and norm >= recipe["max_grad_norm"]:
            g = {p: t * (recipe["max_grad_norm"] / norm) for p, t in g.items()}
        if first is None:
            first = g
        rate = learning_rate(n, recipe["learning_rate"], recipe["schedule_steps"],
                             recipe["warmup_ratio"])
        with torch.no_grad():
            for p, t in params.items():
                mu[p].mul_(b1).add_((1 - b1) * g[p])
                nu[p].mul_(b2).add_((1 - b2) * g[p] * g[p])
                mhat = mu[p] / (1 - b1 ** (n + 1))
                vhat = nu[p] / (1 - b2 ** (n + 1))
                t.sub_(rate * mhat / (vhat.sqrt() + eps))
        del ref, value, grads
    return {"losses": losses, "grad": first,
            "change": {p: (params[p].detach() - start[p]) for p in paths}}


def _leaf(w: dict, path: str) -> torch.Tensor:
    node = w
    for k in path.split("/"):
        node = node[int(k)] if isinstance(node, list) else node[k]
    return node
