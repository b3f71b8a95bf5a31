#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vcoder_tpu_torch``) on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --profile        # also torch.profiler: two B=1 requests and
                                           # the paged engine's decode step at B=8,
                                           # in bf16 and with int4/int8 weights

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit from ``nvidia-smi``.
2. Build: every ``vcoder_tpu_torch/csrc/*.cu`` with ``nvcc`` for ``sm_90a``,
   one process per source, in parallel, into ``vcoder_tpu_torch/_build/``.
3. Kernels against their plain PyTorch versions at the main path's shapes,
   each with its time, its plain version's time, one PyTorch call
   computing the same function as a yardstick, and its bound: flash
   forward, ViT block, the paged kernel in six cases (bf16 and int8
   decode, a verify window of 4, a 128-token chunk window, GQA with a
   length-0 row, an unstacked pool), the int4 decode matmul at B=1 and B=8
   over the 7B gate/up, down and lm_head weights, and the int8 GEMM in both
   forms at the decoder prefill (M=1280) and the tower (M=1731). Kernels and
   yardsticks are timed by CUDA-graph replay, the plain versions eagerly.
4. Main path at full width: VCoder-DS-7B with seeded random bf16 weights
   (built once, shared with phase 6) serves 3 requests (RGB + seg + depth,
   non-square, made from a numpy seed) through ``process_images``,
   ``tokenizer_depth_seg_token`` and ``VCoderForCausalLM.generate``, greedy
   with EOS disabled. The launch counters, set to 0 just before and read
   just after, must show 32 ``flash_fwd`` launches per prefill and 23
   ViT-block launches per tower pass.
6. The paged engine at full width, through ``EngineWorker.from_engine``:
   engine A (bf16 pools) and B (int8 pools) serve 8 concurrent requests of
   32 tokens; C (speculative 4, chunked prefill 128, prefix cache) serves 4
   two-turn conversations. Gates: every request completes; in A and B the
   paged counters equal 32 x the decode steps and flash/ViT launches are
   32/23 per admission; B's first tokens equal A's; C launched the paged
   kernel at windows 4 and 128 and hit the prefix cache.
7. Quantized weights at full width: the phase-4 weights quantized on the
   card (``quantize_params``) to int4 and int8; the 3 requests of phase 4
   through ``generate`` on the int4 model, gated on 362 W8A8 products
   (``int8_mm_scaled``) and 32 flash launches per prefill, 225
   ``int4_matmul`` launches per decode step plus 1 per prefill, no ViT
   block; engine D (int4 weights, bf16 pools) and E (int8 weights, int8
   pools) on engine A's traffic, gated on the same counts per admission
   and per decode step.
5. The checkpoint entry point: ``save_pretrained`` writes a small DS
   checkpoint, ``load_pretrained_model`` loads it on the card as bf16, with
   ``load_4bit`` and with ``load_8bit``, and ``generate`` runs on each;
   their prefill logits through the kernels agree with the plain route.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

# Published dense peaks of one H100 SXM (NVIDIA data sheet), at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_device() -> str:
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    log(out[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return out[0]


def phase_build() -> None:
    from vcoder_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    secs = _kernels.build()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f} s")
    for name, text in _kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                log(f"  ptxas[{name}] {line.strip()}")


def _flash_case(name, B, T, S, H, KH, D, *, causal, n_valid=None, holes=False,
                dead_row=False, seed=0):
    """Inputs for one flash-attention comparison; returns a dict."""
    import torch

    rng = np.random.RandomState(seed)
    dev = "cuda"

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)

    q, k, v = randn(B, T, H, D), randn(B, S, KH, D), randn(B, S, KH, D)
    n_valid = T if n_valid is None else n_valid
    pos = np.zeros((B, T), np.int32)
    pos[:, :n_valid] = np.arange(n_valid) + (S - T if n_valid == T else 0)
    mask = np.zeros((B, S), np.int32)
    mask[:, : (pos.max() + 1) if causal else S] = 1
    if holes:
        mask[:, rng.rand(S) < 0.2] = 0
    if dead_row:
        # Batch row 1, query 0 sees keys 0..pos[1,0]: hide them all.
        mask[1, : pos[1, 0] + 1] = 0
    t = lambda a: torch.from_numpy(a).to(dev)
    return dict(name=name, q=q, k=k, v=v, pos=t(pos), mask=t(mask), causal=causal,
                np_pos=pos, np_mask=mask)


def check_flash(case: dict, report: list) -> None:
    import torch
    import torch.nn.functional as F

    from vcoder_tpu_torch.ops import flash_attention as fa

    q, k, v, pos, mask, causal = (case[x] for x in ("q", "k", "v", "pos", "mask", "causal"))
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    out, lse = fa.launch_flash_fwd(q, k, v, pos, mask, causal=causal, scale=D**-0.5)
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, pos, mask, causal=causal)
    torch.cuda.synchronize()
    err = (out.float() - ref_out.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    # bf16 output: the kernel rounds P per 64-key tile against the running
    # max, the plain version against the final max; both round the output.
    tol, lse_tol = 2e-2, 1e-3
    ok = err <= tol and lse_err <= lse_tol and torch.isfinite(out.float()).all().item()
    log(f"kernel {case['name']}: max_abs_err {err:.3e} (tol {tol}) lse_err {lse_err:.3e} "
        f"(tol {lse_tol}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{case['name']}: kernel disagrees with its plain version")
    ms = graph_ms([lambda: fa.launch_flash_fwd(q, k, v, pos, mask, causal=causal,
                                               scale=D**-0.5)] * 5)
    plain_ms = cuda_ms(lambda: fa.flash_attention_ref(q, k, v, pos, mask, causal=causal), iters=5)
    # Yardstick: SDPA on the same inputs with the same boolean mask.
    kpos = torch.arange(S, device="cuda")
    bmask = mask[:, None, :].bool()
    if causal:
        bmask = bmask & (kpos[None, None, :] <= pos[:, :, None])
    bmask = bmask[:, None]  # [B,1,T,S]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    lib_ms = graph_ms([lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=bmask, enable_gqa=(H != KH))] * 5)
    # Work this data needs: each query row against its visible keys.
    np_pos, np_mask = case["np_pos"], case["np_mask"]
    vis = np.broadcast_to(np_mask[:, None, :].astype(bool), (B, T, S))
    if causal:
        vis = vis & (np.arange(S)[None, None, :] <= np_pos[:, :, None])
    pairs = float(vis.sum()) * H
    n_keys = (int(np_pos.max()) + 1) if causal else S
    flops = 4.0 * D * pairs
    nbytes = (2 * B * T * H * D * 2 + 2 * B * n_keys * KH * D * 2 + B * H * T * 4
              + B * T * 4 + B * S * 4)
    b_ms, b_by = bound(flops, nbytes)
    log(f"  {case['name']}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  "
        f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    if not case.get("report"):
        return
    report.append(dict(name="flash_fwd", route="cuda",
                       source="vcoder_tpu_torch/csrc/flash_fwd.cu",
                       replaces="vcoder_tpu/ops/flash_attention.py:216",
                       launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, status="ok"))


def check_vit_block(report: list) -> None:
    import torch
    import torch.nn.functional as F

    from vcoder_tpu_torch.ops import vit_attention as va

    B, T, Dm, H = 3, 577, 1024, 16
    dh = Dm // H
    rng = np.random.RandomState(1)

    def randn(*shape, s=1.0):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32)).to(
            "cuda", torch.bfloat16)

    layer = {n: randn(Dm, Dm, s=0.03) for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    layer.update({n: randn(Dm, s=0.1) for n in ("q_bias", "k_bias", "v_bias")})
    x = randn(B, T, Dm)
    wqkv_t, bqkv, wo_t = va.repack_block(layer, H)
    y = va.fused_block_attention(x, wqkv_t, bqkv, wo_t, n_heads=H)
    va.launches = 0  # comparison launches do not count
    ref = va.fused_block_attention_ref(x, wqkv_t, bqkv, wo_t, n_heads=H)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = 2e-2 * max(1.0, scale)  # bf16 rounding of qkv, P and o, relative to |y|
    ok = err <= tol and torch.isfinite(y.float()).all().item()
    log(f"kernel vit_block: max_abs_err {err:.3e} (tol {tol:.3e}, max|ref| {scale:.3f}) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("vit_block: kernels disagree with the plain version")
    ms = graph_ms([lambda: va.fused_block_attention(x, wqkv_t, bqkv, wo_t, n_heads=H)] * 5)
    va.launches = 0
    plain_ms = cuda_ms(lambda: va.fused_block_attention_ref(x, wqkv_t, bqkv, wo_t, n_heads=H),
                       iters=5)
    wqkv, wo = wqkv_t.t().contiguous(), wo_t.t().contiguous()
    bq = bqkv.to(torch.bfloat16)

    def library():
        qkv = torch.addmm(bq, x.view(B * T, Dm), wqkv).view(B, T, 3, H, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = F.scaled_dot_product_attention(q, k, v, scale=1.0)
        return o.transpose(1, 2).reshape(B * T, Dm) @ wo

    lib_ms = graph_ms([library] * 5)
    M = B * T
    flops = 2.0 * M * Dm * 3 * Dm + 4.0 * B * H * T * T * dh + 2.0 * M * Dm * Dm
    nbytes = M * Dm * 2 * 2 + 4 * Dm * Dm * 2 + 3 * Dm * 4
    b_ms, b_by = bound(flops, nbytes)
    log(f"  vit_block: kernels {ms:.4f} ms  plain {plain_ms:.4f} ms  addmm+sdpa+mm {lib_ms:.4f} ms  "
        f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    report.append(dict(name="vit_block", route="cuda",
                       source="vcoder_tpu_torch/csrc/gemm_bias.cu",
                       replaces="vcoder_tpu/ops/vit_attention.py:52",
                       launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, status="ok"))


def _paged_case(name, *, B, window, H, KH, lengths, L=32, layer=17, page=64, quant=False,
                stacked=True, seed=0):
    """Inputs for one paged-attention comparison: pools of L layers (or one
    unstacked layer), each row's live pages drawn without replacement from
    pages 1..n-2 (the sentinel and scratch pages are never allocated), table
    entries past a row's pages pointing at the sentinel."""
    import torch

    dev = "cuda"
    rng = np.random.RandomState(seed)
    D = 128
    lengths = np.asarray(lengths, np.int32)
    n_live = -(-lengths // page)
    p_max = int(n_live.max()) + 1
    n_pages = int(n_live.sum()) + 2
    table = np.zeros((B, p_max), np.int32)
    ids = rng.permutation(np.arange(1, n_pages - 1))
    o = 0
    for b in range(B):
        table[b, : n_live[b]] = ids[o : o + n_live[b]]
        o += n_live[b]
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = ((L,) if stacked else ()) + (n_pages, KH, page, D)
    if quant:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev, dtype=torch.int8)
        ks = torch.rand(shape[:-1], generator=gen, device=dev) * (2.0 / 127) + 0.5 / 127
        vs = torch.rand(shape[:-1], generator=gen, device=dev) * (2.0 / 127) + 0.5 / 127
    else:
        kp = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
        vp = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
        ks = vs = None
    q = torch.randn((B, window, H, D), generator=gen, device=dev, dtype=torch.bfloat16)
    return dict(name=name, q=q, kp=kp, vp=vp, ks=ks, vs=vs, layer=layer, window=window,
                table=torch.from_numpy(table).to(dev), lengths=torch.from_numpy(lengths).to(dev),
                np_lengths=lengths, np_table=table, n_live=n_live, page=page, stacked=stacked,
                quant=quant, report=None)


def _paged_dense(case):
    """The yardstick's inputs: each row's live pages gathered beforehand
    into dense [B, H, S, D] K/V (int8 dequantized) and the boolean mask of
    the window-causal rule."""
    import torch

    q, window, page = case["q"], case["window"], case["page"]
    B, k, H, D = q.shape
    kp, vp = case["kp"], case["vp"]
    if case["stacked"]:
        kp, vp = kp[case["layer"]], vp[case["layer"]]
    KH = kp.shape[1]
    n_live = case["n_live"]
    S = int(n_live.max()) * page
    idx = case["table"][:, : int(n_live.max())].long()  # [B, P]

    def dense(pool, scale):
        x = pool[idx]  # [B, P, KH, page, D]
        if scale is not None:
            s = (scale[case["layer"]] if case["stacked"] else scale)[idx]
            x = (x.float() * s[..., None]).to(torch.bfloat16)
        return x.permute(0, 2, 1, 3, 4).reshape(B, KH, S, D)

    kd = dense(kp, case["ks"])
    vd = dense(vp, case["vs"])
    lim = (case["lengths"].long() - window)[:, None] + torch.arange(k, device=q.device)[None, :]
    mask = torch.arange(S, device=q.device)[None, None, :] <= lim[:, :, None]  # [B, k, S]
    return q.transpose(1, 2), kd, vd, mask[:, None]


def check_paged(case: dict, report: list) -> None:
    import torch
    import torch.nn.functional as F

    from vcoder_tpu_torch.ops import paged_attention as pa

    q, kp, vp, ks, vs = (case[x] for x in ("q", "kp", "vp", "ks", "vs"))
    table, lengths, layer, window = case["table"], case["lengths"], case["layer"], case["window"]
    B, k, H, D = q.shape
    if not case["stacked"]:
        run = lambda: pa.paged_attention(q[:, 0], kp, vp, table, lengths)[:, None]
        plain = lambda: pa.paged_attention_ref(q[:, 0], kp, vp, table, lengths)[:, None]
    elif case["quant"]:
        run = lambda: pa.carry_paged_attention_multi_q8(
            q, kp, vp, ks, vs, table, lengths, layer, window=window)
        plain = lambda: pa.carry_paged_attention_multi_q8_ref(
            q, kp, vp, ks, vs, table, lengths, layer, window=window)
    else:
        run = lambda: pa.carry_paged_attention_multi(q, kp, vp, table, lengths, layer, window=window)
        plain = lambda: pa.carry_paged_attention_multi_ref(
            q, kp, vp, table, lengths, layer, window=window)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    # bf16 output of a softmax average of O(1) values: the kernel and the
    # plain version round p against the same per-page maxima and differ only
    # in f32 summation order, then round to bf16 (one ulp is 2**-8 at 1..2).
    tol = 2e-2
    ok = err <= tol and torch.isfinite(out.float()).all().item()
    log(f"kernel {case['name']}: max_abs_err {err:.3e} (tol {tol}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{case['name']}: paged kernel disagrees with its plain version")
    ms = graph_ms([run] * 5)
    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    qt, kd, vd, mask = _paged_dense(case)
    lib_ms = graph_ms([lambda: F.scaled_dot_product_attention(
        qt, kd, vd, attn_mask=mask, enable_gqa=(H != kd.shape[1]))] * 5)
    del kd, vd
    # Work these inputs need: every live page of K and V (scales included)
    # read once, q and out once; each query column against its visible keys.
    KH, page = kp.shape[-3], case["page"]
    elem = 1 if case["quant"] else 2
    live = int(case["n_live"].sum())
    nbytes = (live * 2 * KH * page * (D * elem + (4 if case["quant"] else 0))
              + 2 * B * k * H * D * 2 + table.numel() * 4 + B * 4)
    lim = case["np_lengths"][:, None] - window + np.arange(k)[None, :]
    pairs = float(np.clip(lim + 1, 0, None).sum()) * H
    flops = 4.0 * D * pairs
    b_ms, b_by = bound(flops, nbytes)
    log(f"  {case['name']}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"sdpa over pre-gathered dense K/V (gather excluded) {lib_ms:.4f} ms  "
        f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB)")
    if case["report"]:
        report.append(dict(name=case["report"], route="cuda",
                           source="vcoder_tpu_torch/csrc/paged_attn.cu",
                           replaces=case["replaces"], launches=0, max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms, status="ok"))


def phase_paged_kernels(report: list) -> None:
    """The paged kernel against its plain version at the engine's shapes."""
    import torch

    from vcoder_tpu_torch.ops import paged_attention as pa

    decode_lengths = np.linspace(1201, 1233, 8).astype(np.int32)
    cases = [
        (dict(name="paged bf16 decode B=8 w=1 L=32@17 H=KH=32 page 64 len 1201-1233",
              B=8, window=1, H=32, KH=32, lengths=decode_lengths),
         ("paged_attn_bf16", "vcoder_tpu/ops/paged_attention.py:297")),
        (dict(name="paged int8 decode B=8 w=1 (same shapes)", B=8, window=1, H=32, KH=32,
              lengths=decode_lengths, quant=True, seed=1),
         ("paged_attn_q8", "vcoder_tpu/ops/paged_attention.py:664")),
        (dict(name="paged bf16 verify B=8 w=4", B=8, window=4, H=32, KH=32,
              lengths=decode_lengths + 4, seed=2), None),
        (dict(name="paged bf16 chunk 4 rows w=128", B=4, window=128, H=32, KH=32,
              lengths=[1280, 1216, 1152, 1280], seed=3), None),
        (dict(name="paged bf16 GQA 32q/8kv w=4, a length-0 row, a window across a page",
              B=4, window=4, H=32, KH=8, lengths=[0, 66, 130, 1201], seed=4), None),
        (dict(name="paged unstacked pool (K8) B=8 w=1", B=8, window=1, H=32, KH=32,
              lengths=decode_lengths, L=1, layer=0, stacked=False, seed=5),
         ("paged_attn_k8", "vcoder_tpu/ops/paged_attention.py:55")),
    ]
    for kw, rep in cases:
        case = _paged_case(**kw)
        if rep:
            case["report"], case["replaces"] = rep
        check_paged(case, report)
        del case
        torch.cuda.empty_cache()
    pa.reset_launches()  # comparison launches do not count


def _copies(t, nbytes: int) -> list:
    """``t`` and enough clones that together they exceed the 50 MB L2
    twice: a decode step reads each weight once, from HBM."""
    return [t] + [t.clone() for _ in range(-(-120_000_000 // nbytes) - 1)]


def graph_ms(fns: list, reps: int = 10) -> float:
    """Device ms per call of ``fns`` (each called once per pass), captured
    in one CUDA graph and replayed ``reps`` times between CUDA events: a
    call of a few microseconds takes longer to enqueue from Python than to
    run, so eager back-to-back launches would time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in fns:
            f()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * len(fns))
    del graph
    return ms


def check_int4(B: int, K: int, N: int, report) -> None:
    """K5 against its plain version at a 7B decode shape."""
    import torch

    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops.quant import pack_int4

    rng = np.random.RandomState(K + N + B)
    vals = torch.from_numpy(rng.randint(-8, 8, (K, N)).astype(np.int8)).cuda()
    qp = pack_int4(vals)
    x = torch.from_numpy(rng.randn(B, K).astype(np.float32)).to("cuda", torch.bfloat16)
    y = i4.launch_int4_matmul(x, qp)
    ref = i4.int4_matmul_ref(x, qp)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    # f32 sums in another order, then one bf16 rounding each: two bf16 ulps
    # at the largest output.
    tol = 2.0 ** -7 * max(1.0, scale)
    ok = err <= tol and torch.isfinite(y.float()).all().item()
    name = f"int4_matmul B={B} K={K} N={N}"
    log(f"kernel {name}: max_abs_err {err:.3e} (tol {tol:.3e}, max|ref| {scale:.1f}) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    w_bytes = K // 2 * N
    ms = graph_ms([lambda q=q: i4.launch_int4_matmul(x, q) for q in _copies(qp, w_bytes)])
    plain_ms = cuda_ms(lambda: i4.int4_matmul_ref(x, qp), iters=3, warmup=1)
    wb = vals.to(torch.bfloat16)
    lib_ms = graph_ms([lambda w=w: torch.matmul(x, w) for w in _copies(wb, 2 * K * N)])
    del wb
    flops = 2.0 * B * K * N
    nbytes = w_bytes + B * K * 2 + B * N * 2
    b_ms, b_by = bound(flops, nbytes)
    log(f"  {name}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bf16 matmul over the "
        f"dequantized weight {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}; "
        f"{nbytes / 1e6:.1f} MB; CUDA-graph replay over weight copies >120 MB, L2 cold)")
    torch.cuda.empty_cache()
    if report is not None:
        report.append(dict(name="int4_matmul", route="cuda",
                           source="vcoder_tpu_torch/csrc/int4_matmul.cu",
                           replaces="vcoder_tpu/ops/int4_matmul.py:47",
                           launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, status="ok"))


def check_int8(M: int, K: int, N: int, report) -> None:
    """K10 in both forms against their plain versions at a W8A8 shape."""
    import torch

    from vcoder_tpu_torch.ops import int8_matmul as i8

    rng = np.random.RandomState(M + K + N)
    gen = torch.Generator(device="cuda").manual_seed(M + K)
    a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda", dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), generator=gen, device="cuda", dtype=torch.int8)
    sa = torch.from_numpy((rng.rand(M, 1) * 0.02 + 1e-3).astype(np.float32)).cuda()
    sb = torch.from_numpy((rng.rand(1, N) * 0.002 + 1e-4).astype(np.float32)).cuda()
    c = i8.launch_int8_mm(a, b)
    c_ref = i8.int8_mm_ref(a, b)
    y = i8.launch_int8_mm_scaled(a, b, sa, sb)
    y_ref = i8.int8_mm_scaled_ref(a, b, sa, sb)
    torch.cuda.synchronize()
    err_s32 = (c.long() - c_ref.long()).abs().max().item()
    diff = (y.float() - y_ref.float()).abs()
    err_scaled = diff.max().item()
    # The s32 product is exact; the scaled form rounds the same f32 products
    # once to bf16, so it may differ from the plain version by at most one
    # bf16 rounding (2**-8 of the value).
    ulps = (diff / y_ref.float().abs().clamp_min(1e-30)).max().item()
    ok = err_s32 == 0 and ulps <= 2.0 ** -8 and torch.isfinite(y.float()).all().item()
    name = f"M={M} K={K} N={N}"
    log(f"kernel int8_mm {name}: s32 max_abs_err {err_s32} (tol 0); int8_mm_scaled bf16 "
        f"max_abs_err {err_scaled:.3e}, max relative {ulps:.3e} (tol 2^-8) "
        f"-> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"int8_mm {name}: kernel disagrees with its plain version")
    ops = 2.0 * M * K * N
    for form, run, plain, out_bytes in (
        ("int8_mm", lambda: i8.launch_int8_mm(a, b), lambda: i8.int8_mm_ref(a, b), 4),
        ("int8_mm_scaled", lambda: i8.launch_int8_mm_scaled(a, b, sa, sb),
         lambda: i8.int8_mm_scaled_ref(a, b, sa, sb), 2),
    ):
        ms = graph_ms([run] * 5)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        if form == "int8_mm":
            lib_ms = graph_ms([lambda: torch._int_mm(a, b)] * 5)
        else:
            lib_ms = graph_ms(
                [lambda: (torch._int_mm(a, b).float() * sa * sb).to(torch.bfloat16)] * 5)
        nbytes = M * K + K * N + M * N * out_bytes + (4 * (M + N) if out_bytes == 2 else 0)
        b_ms, b_by = bound(ops, nbytes, PEAK_INT8_OPS)
        log(f"  {form} {name}: kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s)  plain "
            f"{plain_ms:.4f} ms  torch._int_mm{' + epilogue' if out_bytes == 2 else ''} "
            f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}; {ops / 1e9:.1f} GOP at 1979 TOP/s, "
            f"{nbytes / 1e6:.1f} MB)")
        if report is not None:
            report.append(dict(
                name=form, route="cuda", source="vcoder_tpu_torch/csrc/int8_mm.cu",
                replaces=("scripts/bench_int8_matmul.py:76" if form == "int8_mm"
                          else "scripts/bench_int8_matmul.py:92"),
                launches=0, max_abs_err=float(err_s32 if form == "int8_mm" else err_scaled),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                status="ok"))
    del a, b, c, c_ref, y, y_ref
    torch.cuda.empty_cache()


def phase_quant_kernels(report: list) -> None:
    """K5 and K10 against their plain versions at the quantized path's
    shapes: int4 decode at B=1 and B=8 over the 7B q/k/v/o-sized, gate/up,
    down and lm_head weights; the W8A8 product at the decoder prefill
    (M=1280) and the tower (M=1731)."""
    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8

    for B in (1, 8):
        for K, N in ((4096, 11008), (11008, 4096), (4096, 32000)):
            check_int4(B, K, N, report if (B, K, N) == (1, 4096, 11008) else None)
    check_int8(1280, 4096, 11008, report)
    check_int8(1731, 1024, 4096, None)
    i4.launches = 0  # comparison launches do not count
    i8.reset_launches()


def phase_kernels(report: list) -> None:
    # The decoder prefill: T=1280 rows, 1201 valid, a cache of S=1280+32.
    main = _flash_case("flash_fwd causal T=1280 (1201 valid) S=1312 H=KH=32 D=128",
                       1, 1280, 1312, 32, 32, 128, causal=True, n_valid=1201)
    main["report"] = True
    check_flash(main, report)
    check_flash(_flash_case("flash_fwd GQA 8q/2kv, kv_mask holes, a fully-masked row, S>T",
                            2, 200, 333, 8, 2, 128, causal=True, holes=True,
                            dead_row=True, seed=2), report)
    check_flash(_flash_case("flash_fwd d64 bidirectional B=3 T=S=577 H=16",
                            3, 577, 577, 16, 16, 64, causal=False, seed=3), report)
    check_vit_block(report)


def _images(rng, h, w):
    rgb = rng.randint(0, 256, (h, w, 3), dtype=np.uint8)
    seg = np.repeat(np.repeat(rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3),
                                          dtype=np.uint8), 16, 0), 16, 1)[:h, :w]
    depth = (np.linspace(0, 255, w)[None, :] * np.ones((h, 1))).astype(np.uint8)
    return rgb, seg, depth


PROMPT = ("A chat between a curious human and an artificial intelligence assistant. "
          "The assistant gives helpful, detailed, and polite answers to the human's "
          "questions. USER: <depth>\n<seg>\n<image>\nWhat objects can be seen in the "
          "image? Perceive as done for panoptic segmentation. ASSISTANT:")


def _serve(model, tok, pictures, max_new_tokens):
    """One request, end to end: preprocess, tokenize, generate."""
    import torch

    from vcoder_tpu_torch.mm_tokens import tokenizer_depth_seg_token
    from vcoder_tpu_torch.preprocess import process_images

    rgb, seg, depth = pictures
    ids = tokenizer_depth_seg_token(PROMPT, tok)
    px = [process_images([a], dtype=torch.bfloat16, device="cuda") for a in (rgb, seg, depth)]
    res = model.generate([ids], *px, max_new_tokens=max_new_tokens)
    torch.cuda.synchronize()
    return ids, res


def build_7b():
    """VCoder-DS-7B with seeded random bf16 weights and EOS off, built once
    and shared by phases 4 and 6. Returns (cfg, params, model, tokenizer)."""
    import torch

    from vcoder_tpu_torch.builder import VCoderForCausalLM
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.models import vcoder as model_mod
    from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer

    cfg = VCoderConfig.standard("vcoder_ds_llava", "7b")
    # EOS off (an id argmax never emits): every request decodes all tokens.
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, eos_token_id=-1))
    t0 = time.perf_counter()
    params = model_mod.init_vcoder_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _flat(params).values())
    log(f"VCoder-DS-7B random bf16 weights, {n_params / 1e9:.3f} B params, "
        f"init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    tok = SimpleTokenizer.build_from_texts([PROMPT])
    return cfg, params, VCoderForCausalLM(cfg, params), tok


def phase_main_path(cfg, params, model, tok) -> dict:
    """Phase 4: the B=1 path of ``generate``. Returns the launch counts."""
    import torch

    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.ops import vit_attention as va

    rng = np.random.RandomState(0)
    _serve(model, tok, _images(rng, 300, 420), 2)  # warm-up (cuBLAS, allocator)

    sizes = [(480, 640), (720, 540), (375, 500)]
    max_new = 32
    fa.launches = 0
    va.launches = 0
    reqs, prefills = [], 0
    for h, w in sizes:
        pictures = _images(rng, h, w)
        t0 = time.perf_counter()
        ids, first = _serve(model, tok, pictures, 1)
        ttft = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, res = _serve(model, tok, pictures, max_new)
        total = time.perf_counter() - t0
        prefills += 2
        seqs = res.sequences
        ok = (seqs.shape == (1, max_new) and int(res.num_generated[0]) == max_new
              and int(seqs.min()) >= 0 and int(seqs.max()) < cfg.text.vocab_size)
        if not ok:
            raise SystemExit(f"main path: bad output {seqs} {res.num_generated}")
        decode_tps = (max_new - 1) / max(total - ttft, 1e-9)
        reqs.append(dict(hw=[h, w], prompt_ids=len(ids), ttft_ms=ttft * 1e3,
                         total_ms=total * 1e3, decode_tok_s=decode_tps,
                         tokens=seqs[0, :8].tolist()))
        log(f"  request {h}x{w}: {len(ids)} prompt ids, TTFT {ttft * 1e3:.1f} ms, "
            f"{max_new} tokens in {total * 1e3:.1f} ms, decode {decode_tps:.1f} tok/s, "
            f"first tokens {seqs[0, :8].tolist()}")
    n_flash, n_vit = fa.launches, va.launches
    log(f"  TTFT p50 {np.median([r['ttft_ms'] for r in reqs]):.1f} ms, decode p50 "
        f"{np.median([r['decode_tok_s'] for r in reqs]):.1f} tok/s (B=1, host clock)")
    log(f"  launches over {prefills} prefills: flash_fwd {n_flash} ({n_flash / prefills:g} per "
        f"prefill), vit_block {n_vit} ({n_vit / prefills:g} per tower pass)")
    if n_flash != 32 * prefills or n_vit != 23 * prefills:
        raise SystemExit("main path did not go through the kernels as expected")

    # Finite logits of the right shape, and the kernel route beside the plain
    # route on the same request (printed; bf16 differences compound over 32
    # layers of random weights, so this is a reading, not a gate).
    lk, lp, plan = _prefill_routes(params, cfg, tok, _images(np.random.RandomState(7), 480, 640))
    if lk.shape != (1, cfg.text.vocab_size) or not torch.isfinite(lk).all():
        raise SystemExit("main path: prefill logits not finite / wrong shape")
    rel = ((lk - lp).norm() / lp.norm()).item()
    log(f"  prefill T={plan.seq_len} ({int(plan.seq_lens[0])} valid): kernel vs plain route "
        f"logits rel L2 {rel:.3e}, argmax {int(lk.argmax())} vs {int(lp.argmax())}")
    if "--profile" in sys.argv:
        profile_requests(model, tok, _images(np.random.RandomState(8), 480, 640))
    return {"flash_fwd": n_flash, "vit_block": n_vit}


ENGINE_SIZES = [(480, 640), (720, 540), (375, 500), (600, 800), (512, 384), (333, 444),
                (640, 480), (400, 600)]


def _prepared(ids, pictures, max_new):
    """A PreparedRequest carrying the pictures as preprocessed numpy pixels
    [1, 336, 336, 3] (what a front end hands the worker), plus the same
    pixels as bf16 tensors for ``generate``."""
    import torch

    from vcoder_tpu_torch.preprocess import process_images
    from vcoder_tpu_torch.serve.chat import PreparedRequest

    px = [process_images([a], dtype=torch.bfloat16, device="cuda") for a in pictures]
    host = [p.float().cpu().numpy() for p in px]
    prep = PreparedRequest(ori_prompt=PROMPT, input_ids=list(ids), images=host[0], segs=host[1],
                           depths=host[2], max_new_tokens=max_new, temperature=0.0, top_p=1.0,
                           stop_str=None)
    return prep, px


def _drive(worker, preps):
    """Submit every request at once and read each stream on its own thread.
    Returns one dict per request: tokens, TTFT (from the first submit), its
    error."""
    import threading

    results = [None] * len(preps)
    t0 = time.perf_counter()
    handles = [worker.submit(p) for p in preps]

    def read(i, handle):
        toks, times, err = [], [], None
        for tok, done, e in handle:
            times.append(time.perf_counter())
            if e is not None:
                err = e
                break
            toks.append(int(tok))
        results[i] = dict(tokens=toks, ttft_s=(times[0] - t0) if times else None, err=err)

    threads = [threading.Thread(target=read, args=(i, h)) for i, h in enumerate(handles)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise SystemExit("engine: a stream did not finish")
    return results, time.perf_counter() - t0


def _run_engine(label, cfg, params, turns, *, max_new, **kw):
    """Build a paged engine and serve each turn -- a list of requests, or a
    function of the previous turn's results -- through
    EngineWorker.from_engine, every counter set to 0 just before the turn and
    read just after; then shut the worker down and close the engine. Returns
    (results per turn, stats)."""
    import torch

    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8
    from vcoder_tpu_torch.ops import paged_attention as pa
    from vcoder_tpu_torch.ops import vit_attention as va
    from vcoder_tpu_torch.serve.engine_server import EngineWorker
    from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine

    eng = PagedServingEngine(cfg, params, max_batch=8, max_len=2048, page_size=64, eos_id=-1,
                             device="cuda", **kw)
    if kw.get("chunked_prefill"):
        eng.warmup_chunks()
    pool_gib = sum(t.numel() * t.element_size() for t in
                   (eng.k_pages, eng.v_pages, eng.k_scale, eng.v_scale) if t is not None) / 2**30
    worker = EngineWorker.from_engine(eng, model_name="vcoder_ds_llava-7b", eos_id=-1)
    results, walls, counts, decode = [], [], [], []
    try:
        for turn in turns:
            prep_turn = turn(results[-1]) if callable(turn) else turn
            n_steps0 = len(eng.timer.samples.get("decode_step", []))
            fa.launches = va.launches = i4.launches = 0
            pa.reset_launches()
            i8.reset_launches()
            res, wall = _drive(worker, prep_turn)
            torch.cuda.synchronize()
            steps = eng.timer.samples.get("decode_step", [])[n_steps0:]
            counts.append(dict(flash=fa.launches, vit=va.launches, bf16=pa.launches_bf16,
                               q8=pa.launches_q8, k8=pa.launches_k8,
                               by_window=dict(pa.launches_by_window),
                               int4=i4.launches, int8=i8.launches,
                               int8_scaled=i8.launches_scaled,
                               decode_dispatches=len(steps)))
            decode.append((sum(steps), float(np.median(steps)) * 1e3 if steps else float("nan")))
            results.append(res)
            walls.append(wall)
        stats = worker.stats()
    finally:
        worker.shutdown()
        eng.close()
        torch.cuda.empty_cache()
    for t, (res, wall, c, (dec_s, step_p50)) in enumerate(zip(results, walls, counts, decode)):
        bad = [r for r in res if r["err"] is not None or len(r["tokens"]) != max_new]
        if bad:
            raise SystemExit(f"engine {label}: requests did not complete: {bad[:2]}")
        ttft = np.median([r["ttft_s"] for r in res]) * 1e3
        n_tok = sum(len(r["tokens"]) - 1 for r in res)
        log(f"  engine {label} turn {t + 1}: {len(res)} requests x {max_new} tokens in "
            f"{wall:.2f} s; TTFT p50 {ttft:.1f} ms; aggregate decode {n_tok / dec_s:.1f} tok/s "
            f"({n_tok} tokens after the first over {dec_s:.2f} s of decode steps); per-step "
            f"wall p50 {step_p50:.2f} ms over {c['decode_dispatches']} steps; "
            f"launches {json.dumps(c)}")
    log(f"  engine {label}: pools {pool_gib:.2f} GiB, prefix {json.dumps(stats.get('prefix_cache'))}, "
        f"preemptions {stats.get('preemptions')}")
    return results, dict(counts=counts, prefix=stats.get("prefix_cache"))


def phase_engines(cfg, params, model, tok) -> dict:
    """Phase 6: the paged engine at full width through EngineWorker.from_engine.
    A: bf16 pools; B: int8 pools; C: speculative=4 + chunked prefill 128 +
    prefix cache over 4 two-turn conversations. Returns launch totals."""
    import torch

    from vcoder_tpu_torch.mm_tokens import tokenizer_depth_seg_token

    max_new = 32
    rng = np.random.RandomState(11)
    ids = tokenizer_depth_seg_token(PROMPT, tok)
    reqs = [_prepared(ids, _images(rng, h, w), max_new) for h, w in ENGINE_SIZES]
    preps = [p for p, _ in reqs]

    (res_a,), st_a = _run_engine("A (bf16 pools)", cfg, params, [preps], max_new=max_new)
    (res_b,), st_b = _run_engine("B (int8 pools)", cfg, params, [preps], max_new=max_new,
                                 kv_quant=True)
    n = len(preps)
    ca, cb = st_a["counts"][0], st_b["counts"][0]
    if ca["k8"] != 32 * ca["decode_dispatches"] or ca["bf16"] or ca["q8"]:
        raise SystemExit(f"engine A: paged launches {ca} != 32 x decode dispatches")
    if cb["q8"] != 32 * cb["decode_dispatches"] or cb["k8"] or cb["bf16"]:
        raise SystemExit(f"engine B: paged launches {cb} != 32 x decode dispatches")
    for label, c in (("A", ca), ("B", cb)):
        if c["flash"] != 32 * n or c["vit"] != 23 * n:
            raise SystemExit(f"engine {label}: flash/ViT launches {c} != 32/23 per admission")
    first_a = [r["tokens"][0] for r in res_a]
    first_b = [r["tokens"][0] for r in res_b]
    if first_a != first_b:
        raise SystemExit(f"engines A and B disagree on first tokens: {first_a} vs {first_b}")
    agree_b = sum(int(x == y) for ra, rb in zip(res_a, res_b)
                  for x, y in zip(ra["tokens"][1:], rb["tokens"][1:]))
    dense_first = dense_decode = 0
    for (prep, px), ra in zip(reqs, res_a):
        out = model.generate([ids], *px, max_new_tokens=max_new).sequences[0].tolist()
        dense_first += int(out[0] == ra["tokens"][0])
        dense_decode += sum(int(x == y) for x, y in zip(out[1:], ra["tokens"][1:]))
    torch.cuda.synchronize()
    log(f"  A vs dense generate (prompt padded to 1280, not the engine's 1536 bucket): first "
        f"tokens {dense_first}/{n} agree, decode tokens {dense_decode}/{n * (max_new - 1)}; "
        f"B vs A decode tokens {agree_b}/{n * (max_new - 1)}; B's first tokens equal A's")

    extra = tok.encode("what else can be seen")[1:]

    def turn2(turn1):
        return [dataclasses.replace(p, input_ids=list(p.input_ids) + r["tokens"] + extra)
                for p, r in zip(preps[:4], turn1)]

    if "--profile" in sys.argv:
        profile_engine_decode(cfg, preps, [("engine_bf16_decode_step", params, {}),
                                           ("engine_int8_decode_step", params,
                                            {"kv_quant": True})])
    _, st_c = _run_engine("C (speculative 4, chunked prefill 128, prefix cache)", cfg, params,
                              [preps[:4], turn2], max_new=max_new, speculative=4,
                              chunked_prefill=128, prefix_cache=True)
    cc = st_c["counts"]
    wins = {w for c in cc for w in c["by_window"]}
    if not {4, 128} <= wins:
        raise SystemExit(f"engine C: paged launches by window {wins} lack 4 or 128")
    if st_c["prefix"]["hits"] <= 0:
        raise SystemExit(f"engine C: no prefix hits {st_c['prefix']}")
    totals = {}
    for c in [ca, cb] + cc:
        for key in ("flash", "vit", "bf16", "q8", "k8"):
            totals[key] = totals.get(key, 0) + c[key]
    return totals


@contextlib.contextmanager
def plain_quant_route():
    """The plain route of the quantized matmuls, for a reading of the
    kernel route against it: ``qmatmul`` calls the int4 and W8A8 products
    through their modules, so pointing those names at the plain versions
    swaps the route (the wrappers themselves only ever launch on CUDA).
    Fails if any kernel launched inside, so that a reading of the kernel
    route cannot quietly compare the kernels with themselves."""
    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8
    from vcoder_tpu_torch.ops import paged_attention as pa
    from vcoder_tpu_torch.ops import vit_attention as va

    def counts():
        return (fa.launches, va.launches, i4.launches, i8.launches, i8.launches_scaled,
                pa.launches_bf16, pa.launches_q8, pa.launches_k8)

    before = counts()
    saved = i4.int4_matmul, i8.int8_mm_scaled
    i4.int4_matmul, i8.int8_mm_scaled = i4.int4_matmul_ref, i8.int8_mm_scaled_ref
    try:
        yield
    finally:
        i4.int4_matmul, i8.int8_mm_scaled = saved
    if counts() != before:
        raise SystemExit(f"plain route launched kernels: counts {before} -> {counts()}")


def _prefill_routes(params, cfg, tok, pictures):
    """Last-token prefill logits of one DS request through the kernels and
    through the plain route (plain attention, plain quantized products)."""
    import torch

    from vcoder_tpu_torch.mm_tokens import tokenizer_depth_seg_token
    from vcoder_tpu_torch.models import vcoder as model_mod
    from vcoder_tpu_torch.multimodal import build_splice_plan
    from vcoder_tpu_torch.preprocess import process_images

    ids = tokenizer_depth_seg_token(PROMPT, tok)
    plan = build_splice_plan([ids], num_patches=cfg.vision.num_patches, has_image=True,
                             has_seg=True, has_depth=True, ds_mode=True)
    arrays = model_mod.plan_to_arrays(plan, "cuda")
    dtype = params["lm"]["embed_tokens"].dtype
    px = [process_images([a], dtype=dtype, device="cuda") for a in pictures]
    with torch.no_grad():
        lk, _ = model_mod.prefill(params, cfg, arrays, *px, use_vcoder_emb=True)
        with plain_quant_route():
            lp, _ = model_mod.prefill(params, cfg, arrays, *px, use_vcoder_emb=True,
                                      attn_impl="xla")
    torch.cuda.synchronize()
    return lk, lp, plan


def phase_quantized(cfg, params, tok) -> dict:
    """Phase 7: quantized weights at full width. The phase-4 bf16 weights
    quantized on the card to int4 and to int8 (``quantize_params``, the bf16
    tree kept); the 3 requests of phase 4 through ``generate`` on the int4
    model; engine D (int4 weights, bf16 pools) and engine E (int8 weights,
    int8 pools) on engine A's traffic. Returns launch totals."""
    import torch

    from vcoder_tpu_torch.builder import VCoderForCausalLM
    from vcoder_tpu_torch.mm_tokens import tokenizer_depth_seg_token
    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8
    from vcoder_tpu_torch.ops import paged_attention as pa
    from vcoder_tpu_torch.ops import vit_attention as va
    from vcoder_tpu_torch.quant import quantize_params

    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    q4 = quantize_params(params, bits=4, destroy=False)
    torch.cuda.synchronize()
    gib4 = (torch.cuda.memory_allocated() - base) / 2**30
    q8 = quantize_params(params, bits=8, destroy=False)
    torch.cuda.synchronize()
    gib8 = (torch.cuda.memory_allocated() - base) / 2**30 - gib4
    log(f"quantized (phase 7): int4 leaves {gib4:.2f} GiB, int8 leaves {gib8:.2f} GiB, in "
        f"{time.perf_counter() - t0:.1f} s; {torch.cuda.memory_allocated() / 2**30:.1f} GiB "
        f"allocated with the bf16 tree")
    model4 = VCoderForCausalLM(cfg, q4)
    totals = {k: 0 for k in ("flash", "vit", "bf16", "q8", "k8", "int4", "int8", "int8_scaled")}

    # B=1 requests on the int4 model: a TTFT request and a 32-token request each.
    rng = np.random.RandomState(0)
    _serve(model4, tok, _images(rng, 300, 420), 2)  # warm-up
    max_new = 32
    fa.launches = va.launches = i4.launches = 0
    i8.reset_launches()
    reqs, prefills, steps = [], 0, 0
    for h, w in [(480, 640), (720, 540), (375, 500)]:
        pictures = _images(rng, h, w)
        t1 = time.perf_counter()
        _serve(model4, tok, pictures, 1)
        ttft = time.perf_counter() - t1
        t1 = time.perf_counter()
        _, res = _serve(model4, tok, pictures, max_new)
        total = time.perf_counter() - t1
        prefills, steps = prefills + 2, steps + max_new - 1
        seqs = res.sequences
        if not (seqs.shape == (1, max_new) and int(seqs.min()) >= 0
                and int(seqs.max()) < cfg.text.vocab_size):
            raise SystemExit(f"int4 generate: bad output {seqs}")
        reqs.append(dict(ttft_ms=ttft * 1e3, decode_tok_s=(max_new - 1) / max(total - ttft, 1e-9)))
        log(f"  int4 request {h}x{w}: TTFT {ttft * 1e3:.1f} ms, {max_new} tokens in "
            f"{total * 1e3:.1f} ms, decode {reqs[-1]['decode_tok_s']:.1f} tok/s, first tokens "
            f"{seqs[0, :8].tolist()}")
    c = dict(flash=fa.launches, vit=va.launches, int4=i4.launches, int8=i8.launches,
             int8_scaled=i8.launches_scaled)
    log(f"  int4 B=1: TTFT p50 {np.median([r['ttft_ms'] for r in reqs]):.1f} ms, decode p50 "
        f"{np.median([r['decode_tok_s'] for r in reqs]):.1f} tok/s (host clock); launches over "
        f"{prefills} prefills and {steps} decode steps: {json.dumps(c)}")
    # Per prefill: 224 decoder and 138 tower W8A8 products (>= 256 tokens),
    # lm_head on one token through K5, 32 flash launches, no ViT block (the
    # quantized tower is unfused); per decode step 32 x 7 + lm_head K5.
    want = dict(flash=32 * prefills, vit=0, int4=prefills + 225 * steps, int8=0,
                int8_scaled=362 * prefills)
    if c != want:
        raise SystemExit(f"int4 generate: launches {c} != {want}")
    for k in c:
        totals[k] += c[k]

    lk, lp, plan = _prefill_routes(q4, cfg, tok, _images(np.random.RandomState(7), 480, 640))
    if lk.shape != (1, cfg.text.vocab_size) or not torch.isfinite(lk).all():
        raise SystemExit("int4 prefill logits not finite / wrong shape")
    rel = ((lk - lp).norm() / lp.norm()).item()
    log(f"  int4 prefill T={plan.seq_len}: kernel vs plain route logits rel L2 {rel:.3e}, "
        f"argmax {int(lk.argmax())} vs {int(lp.argmax())} (a reading)")

    ids = tokenizer_depth_seg_token(PROMPT, tok)
    reqs = [_prepared(ids, _images(np.random.RandomState(11), h, w), max_new)
            for h, w in ENGINE_SIZES]
    preps = [p for p, _ in reqs]
    n = len(preps)
    for label, qp, kw, paged in (("D (int4 weights, bf16 pools)", q4, {}, "k8"),
                                 ("E (int8 weights, int8 pools)", q8, {"kv_quant": True}, "q8")):
        (res,), st = _run_engine(label, cfg, qp, [preps], max_new=max_new, **kw)
        ce = st["counts"][0]
        d = ce["decode_dispatches"]
        want = dict(flash=32 * n, vit=0, int8_scaled=362 * n, int8=0,
                    int4=(225 * d + n) if qp is q4 else 0)
        want[paged] = 32 * d
        got = {k: ce[k] for k in want}
        other = [k for k in ("bf16", "q8", "k8") if k != paged and ce[k]]
        if got != want or other:
            raise SystemExit(f"engine {label}: launches {got} != {want} (or {other} nonzero)")
        for k in totals:
            totals[k] += ce[k]
        if qp is q4:
            first = [r["tokens"][0] for r in res]
            gen_first = [int(model4.generate([ids], *px, max_new_tokens=1).sequences[0, 0])
                         for _, px in reqs]
            log(f"  D vs int4 generate (prompt padded to 1280, not the engine's 1536 bucket): "
                f"first tokens {sum(int(a == b) for a, b in zip(first, gen_first))}/{n} agree "
                f"(a reading)")
    if "--profile" in sys.argv:
        profile_requests(model4, tok, _images(np.random.RandomState(8), 480, 640),
                         tag="profile_int4")
        profile_engine_decode(cfg, preps, [("engine_D_decode_step", q4, {}),
                                           ("engine_E_decode_step", q8, {"kv_quant": True})],
                              tag="profile_engine_quantized")
    del q4, q8, model4
    torch.cuda.empty_cache()
    return totals


def _kernel_class(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_fwd (port)"
    if "gemm_bias" in name:
        return "gemm_bias (port)"
    if "paged_attn" in name:
        return "paged_attn (port)"
    if "int4_matmul" in name or "int4_split_sum" in name:
        return "int4_matmul (port)"
    if "int8_mm" in name:
        return "int8_mm (port)"
    low = name.lower()
    if any(k in low for k in ("nvjet", "gemm", "cutlass", "xmma", "sm90", "cublas", "splitk")):
        return "cuBLAS matmul"
    return "other (elementwise, reductions, copies, gathers)"


def _profile(label: str, fn, per: int = 1) -> dict:
    """``torch.profiler`` over ``fn()``: device time by kernel class,
    device-busy time against the host clock, the top kernels; times are
    divided by ``per`` (steps in the window)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / per
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, by_class = {}, {}
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3 / per
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        c = _kernel_class(e.name)
        by_class[c] = by_class.get(c, 0.0) + ms
    busy = sum(by_class.values())
    out = dict(wall_ms=wall_ms, device_busy_ms=busy, n_kernels=len(kernels) / per,
               by_class=by_class, top=sorted(by_name.items(), key=lambda kv: -kv[1])[:15])
    log(f"profile {label}: wall {wall_ms:.2f} ms, device busy {busy:.2f} ms "
        f"(idle share {1 - busy / wall_ms:.3f}), {len(kernels) / per:.0f} kernel launches"
        + (f" (per step, over {per} steps)" if per > 1 else ""))
    for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"    {ms:9.3f} ms  {c}")
    for name, ms in out["top"][:8]:
        log(f"    top {ms:9.3f} ms  {name[:100]}")
    return out


def profile_requests(model, tok, pictures, tag: str = "profile") -> None:
    """``--profile``: one TTFT request and one 32-token request of the B=1
    path, printed as one ``<tag>: {...}`` JSON line."""
    out = {label: _profile(f"{tag} {label}", lambda n=max_new: _serve(model, tok, pictures, n))
           for label, max_new in (("ttft", 1), ("request_32", 32))}
    log(f"{tag}: " + json.dumps(out))


def profile_engine_decode(cfg, preps, engines, steps: int = 8,
                          tag: str = "profile_engine") -> None:
    """``--profile``: the paged engine's decode step at B=8, for each
    ``(label, params, engine kwargs)`` of ``engines``. All 8 requests are
    admitted first; the window covers ``steps`` pure decode steps. Printed
    as one ``<tag>: {...}`` JSON line."""
    import torch

    from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine

    out = {}
    for label, params, kw in engines:
        eng = PagedServingEngine(cfg, params, max_batch=8, max_len=2048, page_size=64,
                                 eos_id=-1, device="cuda", **kw)
        for p in preps:
            eng.add_request(p.input_ids, images=p.images, segs=p.segs, depths=p.depths,
                            max_new_tokens=64)
        eng.step()  # admit all 8 (dense prefill) and run one decode step
        eng.step()
        if not eng.active.all():
            raise SystemExit("profile: the engine did not admit every request")
        out[label] = _profile(label, lambda: [eng.step() for _ in range(steps)], per=steps)
        eng.close()
        torch.cuda.empty_cache()
    log(f"{tag}: " + json.dumps(out))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def phase_checkpoint() -> None:
    """The checkpoint entry point: a small DS checkpoint saved, then loaded
    on the card three ways -- bf16, ``load_4bit`` and ``load_8bit`` -- and
    served through ``generate``; each variant's prefill logits through the
    kernels agree with the plain route."""
    import torch

    from vcoder_tpu_torch.builder import load_pretrained_model
    from vcoder_tpu_torch.checkpoint import save_pretrained
    from vcoder_tpu_torch.config import TextConfig, VCoderConfig, VisionConfig
    from vcoder_tpu_torch.mm_tokens import tokenizer_depth_seg_token
    from vcoder_tpu_torch.models import vcoder as model_mod
    from vcoder_tpu_torch.multimodal import build_splice_plan
    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8
    from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer

    # Small, but with the kernels' head dims: 64 in the tower, 128 in the LM.
    cfg = VCoderConfig(
        model_type="vcoder_ds_llava",
        vision=VisionConfig(image_size=56, hidden_size=128, intermediate_size=256,
                            num_layers=3, num_heads=2),
        text=TextConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                        num_layers=2, num_heads=2, num_kv_heads=1, eos_token_id=-1),
        use_seg=True, use_depth=True, use_mm2_proj=True, use_vcoder_lm_emb=True,
    )
    params = model_mod.init_vcoder_params(cfg, seed=1, dtype=torch.float32, device="cuda")
    tok = SimpleTokenizer.build_from_texts([PROMPT])
    rgb, seg, depth = _images(np.random.RandomState(3), 90, 70)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/vcoder_ds_llava-smoke"
        save_pretrained(path, params, cfg)
        tok.save_pretrained(path)
        for label, kw in (("bf16", {}), ("load_4bit", {"load_4bit": True}),
                          ("load_8bit", {"load_8bit": True})):
            tokenizer, model, proc, seg_proc, depth_proc, ctx = load_pretrained_model(path, **kw)
            if seg_proc is None or depth_proc is None or model.device.type != "cuda":
                raise SystemExit("checkpoint: wrong processors or device")
            if not kw:
                saved, loaded = _flat(params), _flat(model.params)
                if saved.keys() != loaded.keys() or not all(
                    torch.equal(saved[k].to(torch.bfloat16), loaded[k]) for k in saved
                ):
                    raise SystemExit("checkpoint: loaded weights differ from the saved ones")
            px = [proc([a])["pixel_values"].to(torch.bfloat16) for a in (rgb, seg, depth)]
            ids = tokenizer_depth_seg_token(PROMPT, tokenizer)
            i4.launches = 0
            i8.reset_launches()
            res = model.generate([ids], *px, max_new_tokens=8, tokenizer=tokenizer)
            torch.cuda.synchronize()
            n_int4 = i4.launches
            plan = build_splice_plan([ids], num_patches=cfg.vision.num_patches, has_image=True,
                                     has_seg=True, has_depth=True, ds_mode=True)
            arrays = model_mod.plan_to_arrays(plan, "cuda")
            lk, _ = model_mod.prefill(model.params, model.config, arrays, *px,
                                      use_vcoder_emb=True)
            with plain_quant_route():
                lp, _ = model_mod.prefill(model.params, model.config, arrays, *px,
                                          use_vcoder_emb=True, attn_impl="xla")
            err = (lk - lp).abs().max().item()
            tol = 2e-2 * max(1.0, lp.abs().max().item())
            ok = (res.sequences.shape == (1, 8) and torch.isfinite(lk).all().item()
                  and err <= tol and int(lk.argmax()) == int(lp.argmax())
                  and (n_int4 > 0) == (label == "load_4bit"))
            log(f"checkpoint {label}: loaded {path.rsplit('/', 1)[-1]} via "
                f"load_pretrained_model, tokens {res.sequences[0].tolist()}, int4_matmul "
                f"launches in generate {n_int4}, prefill logits kernel vs plain route "
                f"max_abs_err {err:.3e} (tol {tol:.3e}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"checkpoint phase failed ({label})")
            del model


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import vcoder_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the vcoder_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    report: list = []
    phase_kernels(report)
    phase_paged_kernels(report)
    phase_quant_kernels(report)
    cfg, params, model, tok = build_7b()
    main_counts = phase_main_path(cfg, params, model, tok)
    log("engines (phase 6): VCoder-DS-7B, max_batch 8, max_len 2048, page 64, EOS off")
    engine_counts = phase_engines(cfg, params, model, tok)
    quant_counts = phase_quantized(cfg, params, tok)
    del params, model
    torch.cuda.empty_cache()
    # Each entry's launches: the sum over the driven paths, each counted from
    # 0 just before it ran and read just after.
    launches = {
        "flash_fwd": main_counts["flash_fwd"] + engine_counts["flash"] + quant_counts["flash"],
        "vit_block": main_counts["vit_block"] + engine_counts["vit"] + quant_counts["vit"],
        "paged_attn_bf16": engine_counts["bf16"] + quant_counts["bf16"],
        "paged_attn_q8": engine_counts["q8"] + quant_counts["q8"],
        "paged_attn_k8": engine_counts["k8"] + quant_counts["k8"],
        "int4_matmul": quant_counts["int4"],
        "int8_mm": quant_counts["int8"],
        "int8_mm_scaled": quant_counts["int8_scaled"],
    }
    for entry in report:
        entry["launches"] = launches[entry["name"]]
    log(f"launches on the driven paths: {json.dumps(launches)}")
    phase_checkpoint()
    log(f"wall {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
