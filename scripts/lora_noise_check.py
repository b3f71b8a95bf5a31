#!/usr/bin/env python3
"""How far ``chip_smoke.py`` phase 15's one-device ``lora`` stage moves
from itself when only its rounding changes, on one card.

    python3 scripts/lora_noise_check.py

Phase 15 holds the mesh's lora stage (4 steps at B=4, rank 128, alpha 256,
lr 2e-4) within 3e-2 of the one-device run in each adapter leaf's gradient
norm. This script runs the one-device stage, for each start of the
adapters' B (zero, as the LoRA recipe starts, and drawn N(0, std)):

* twice as it is (is one device reproducible?);
* once with every row-parallel product (``o_proj``, ``down_proj``, the
  LoRA term included) split into the two halves of its contraction, each
  half's product rounded to bf16 and the halves summed in bf16: what two
  model ranks compute under autograd (``spmd.partial_product``, then
  ``reduce_from_model``), with nothing else changed.

For each run it prints each step's loss gap and the largest gradient-norm
gap over the adapters' ``a`` leaves, their ``b`` leaves and the other
trained leaves, against the first run; the tower takes the unfused blocks,
as phase 15's one-device reference does.
"""

import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402

# The starts of B: zero (phase 15's recipe start) and two warm starts.
B_STDS = (0.0, 1e-2, 3e-2)


def _row_halves(w, h):
    """The two row blocks of one layer's weight (a LoRA's ``a`` split with
    its base, ``b`` whole)."""
    from vcoder_tpu_torch.lora import LoraWeight

    if isinstance(w, LoraWeight):
        return [LoraWeight(w.base[s], w.a[s], w.b, w.scale) for s in (slice(None, h), slice(h, None))]
    return [w[:h], w[h:]]


@contextlib.contextmanager
def split_row_parallel():
    """``llama._layer_out`` with its row-parallel products split in two."""
    from vcoder_tpu_torch.models import llama

    def split(a, w):
        h = a.shape[-1] // 2
        w0, w1 = _row_halves(w, h)
        return llama.qm(a[..., :h], w0) + llama.qm(a[..., h:], w1)

    def layer_out(lp, cfg, x, attn):
        B, T = attn.shape[:2]
        x = x + split(attn.reshape(B, T, -1), lp["o_proj"])
        h = llama.rms_norm(x, lp["post_attention_layernorm"], cfg.rms_norm_eps)
        a = F.silu(llama.qm(h, lp["gate_proj"])) * llama.qm(h, lp["up_proj"])
        return x + split(a, lp["down_proj"])

    orig = llama._layer_out
    llama._layer_out = layer_out
    try:
        yield
    finally:
        llama._layer_out = orig


def gaps(run: dict, ref: dict) -> list:
    """Per step: the loss gap and the largest relative gradient-norm gap
    over ``a`` leaves, ``b`` leaves and the rest."""
    out = []
    for i, (n, rn) in enumerate(zip(run["norms"], ref["norms"])):
        step = dict(step=i + 1, loss=abs(run["losses"][i] - ref["losses"][i]) / abs(ref["losses"][i]))
        for k, v in rn.items():
            kind = k.rsplit("/", 1)[-1] if k.startswith("lm/layers/") else "other"
            rel = abs(n[k] - v) / abs(v) if v else abs(n[k])
            step[kind] = max(step.get(kind, 0.0), rel)
        out.append({k: (round(v, 6) if isinstance(v, float) else v) for k, v in step.items()})
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("lora_noise_check: CUDA is not available", file=sys.stderr)
        return 2
    from vcoder_tpu_torch.models import clip

    t0 = time.perf_counter()
    smi = cs.phase_device()
    cs.phase_build()
    cfg, params, _, _ = cs.build_model(device="cuda")
    clip.FUSED_BLOCKS = False
    results = {}
    for std in B_STDS:
        lora = dict(cs.SHARDED_LORA, b_std=std)
        ref = cs.sharded_training(cfg, params, None, "cuda", stage="lora", lora=lora)
        again = cs.sharded_training(cfg, params, None, "cuda", stage="lora", lora=lora)
        with split_row_parallel():
            split = cs.sharded_training(cfg, params, None, "cuda", stage="lora", lora=lora)
        res = dict(losses=ref["losses"], again=gaps(again, ref), split=gaps(split, ref))
        results[f"b_std={std}"] = res
        cs.log(f"lora noise b_std={std}: {json.dumps(res)}")
    cs.log("lora noise: " + json.dumps(results))
    cs.log(f"wall {time.perf_counter() - t0:.1f} s on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
