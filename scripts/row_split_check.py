#!/usr/bin/env python3
"""How much of a tensor-parallel split's gap comes from rounding the
row-parallel partial sums, measured on one card.

    python3 scripts/row_split_check.py

Builds VCoder-DS-7B as ``chip_smoke.py`` does, runs its product check
(``check_row_split``: layer 0's o_proj and down_proj with the contraction
split in halves), then serves engine A's traffic (phase 15's) three times on
one device, the tower on its unfused blocks as under a mesh:

* ``exact``: the one-device forward;
* ``bf16``: every decoder and tower layer's o/out and down/fc2 product
  computed as two halves of its contraction, each rounded to bf16 and
  summed in bf16 (what a model split of 2 gives with bf16 partials);
* ``f32``: the same halves as ``spmd.partial_product``'s f32 partials,
  summed and rounded once (what ``spmd.row_parallel`` gives);
* ``f32_decoder`` / ``f32_tower``: the f32 split in the decoder's layers
  alone / the tower's alone;
* ``fused_tower``: no split, the tower on its fused blocks (K2), the
  one-device route outside a mesh.

It also reports the share of elements in which a product split by output
columns in halves (a column-parallel product) differs from the full one.

Prints one JSON line: each split's largest prefill-logit relative L2 from
``exact``, its equal first tokens and its share of equal later tokens, held
against phase 15's bound ``SHARDED_LOGIT_REL_L2``.
"""

import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _split_sum(route: str, x, w, matmul):
    """``matmul(x, w)`` with the contraction split in halves, the halves
    summed by ``route``: ``f32`` (``spmd.partial_product``'s f32 partials,
    rounded once after the sum) or ``bf16`` (each half rounded, then summed
    in bf16)."""
    from vcoder_tpu_torch.parallel import spmd

    h = w.shape[0] // 2
    halves = [(x[..., :h].contiguous(), w[:h]), (x[..., h:].contiguous(), w[h:])]
    if route == "f32":
        a, b = (spmd.partial_product(xi, wi, matmul) for xi, wi in halves)
        return (a + b).to(x.dtype)
    return matmul(*halves[0]) + matmul(*halves[1])


class _Halves:
    """A tower weight whose product :func:`split_products` splits."""

    def __init__(self, w):
        self.w = w


@contextlib.contextmanager
def split_products(route: str, where: str = "all"):
    """Within: the layers of ``where`` (``all``, ``decoder`` or ``tower``)
    compute their o/out and down/fc2 products with the contraction split in
    two halves on this device, summed by ``route`` (:func:`_split_sum`)."""
    from vcoder_tpu_torch.models import clip
    from vcoder_tpu_torch.parallel import spmd

    real_layer, real_rp = spmd.layer, spmd.row_parallel
    real_clip_layer, real_qm = clip._layer, clip.qm

    def layer(stack, l, **kw):  # the decoder's layers (the tower's pass no heads)
        out = real_layer(stack, l, **kw)
        out["tp_attn"] = out["tp_mlp"] = True
        return out

    def clip_layer(params, l):
        out = dict(real_clip_layer(params, l))
        out["out_proj"], out["fc2"] = _Halves(out["out_proj"]), _Halves(out["fc2"])
        return out

    def clip_qm(x, w):
        return _split_sum(route, x, w.w, real_qm) if isinstance(w, _Halves) else real_qm(x, w)

    if where in ("all", "decoder"):
        spmd.layer = layer
        spmd.row_parallel = lambda x, w, matmul: _split_sum(route, x, w, matmul)
    if where in ("all", "tower"):
        clip._layer, clip.qm = clip_layer, clip_qm
    try:
        yield
    finally:
        spmd.layer, spmd.row_parallel = real_layer, real_rp
        clip._layer, clip.qm = real_clip_layer, real_qm


def column_split_exact(params) -> dict:
    """Whether a product whose output columns are split in halves (the
    column-parallel products of a model split of 2) gives the full
    product's columns bit for bit, at a prefill's rows and a decode step's."""
    from vcoder_tpu_torch.ops.quant import qmatmul as qm

    lm, vt = params["lm"], params["vision_tower"]["layers"]
    weights = {"q_proj": lm["layers"]["q_proj"][0], "gate_proj": lm["layers"]["gate_proj"][0],
               "lm_head": lm["lm_head"], "tower_fc1": vt["fc1"][0]}
    gen = torch.Generator(device="cuda").manual_seed(22)
    out = {}
    with torch.no_grad():
        for name, w in weights.items():
            for m in (cs.ROW_SPLIT_M, 8, 4):
                x = torch.randn((m, w.shape[0]), generator=gen, device="cuda", dtype=w.dtype)
                full = qm(x, w)
                n = w.shape[1] // 2
                halves = [qm(x, w[:, :n].contiguous()), qm(x, w[:, n:].contiguous())]
                out[f"{name} M={m}"] = float((torch.cat(halves, 1) != full).float().mean())
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("row_split_check: CUDA is not available", file=sys.stderr)
        return 2
    from vcoder_tpu_torch.models import clip

    t0 = time.perf_counter()
    smi = cs.phase_device()
    cs.phase_build()
    cfg, params, _, _ = cs.build_model()
    products = cs.check_row_split(params)
    traffic = cs.sharded_traffic(cfg)
    engines = {"A": cs.SHARDED_ENGINES["A"]}
    cs.SHARDED_ENGINES = engines
    clip.FUSED_BLOCKS = False
    columns = column_split_exact(params)
    runs = {"exact": cs.sharded_engines(cfg, {None: params}, traffic, None, "cuda")["A"]}
    splits = {"bf16": ("bf16", "all"), "f32": ("f32", "all"),
              "f32_decoder": ("f32", "decoder"), "f32_tower": ("f32", "tower")}
    for label, (route, where) in splits.items():
        with split_products(route, where):
            runs[label] = cs.sharded_engines(cfg, {None: params}, traffic, None, "cuda")["A"]
    clip.FUSED_BLOCKS = True
    runs["fused_tower"] = cs.sharded_engines(cfg, {None: params}, traffic, None, "cuda")["A"]
    ref = runs["exact"]
    gaps = {}
    for route in list(splits) + ["fused_tower"]:
        got = runs[route]
        rel = [cs._rel_l2(a, b) for a, b in zip(got["logits"], ref["logits"])]
        later = [x == y for a, b in zip(got["tokens"], ref["tokens"])
                 for x, y in zip(a[1:], b[1:])]
        gaps[route] = dict(logit_rel_l2=[round(r, 5) for r in rel],
                           logit_rel_l2_max=round(max(rel), 5),
                           first_equal=sum(a[0] == b[0] for a, b in
                                           zip(got["tokens"], ref["tokens"])),
                           later_equal=round(sum(later) / len(later), 4))
    print(json.dumps({"row_split": {"products": products, "column_split_differ": columns,
                                    "engine_A": gaps,
                                    "bound": cs.SHARDED_LOGIT_REL_L2}}))
    cs.log(f"wall {time.perf_counter() - t0:.1f} s on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
