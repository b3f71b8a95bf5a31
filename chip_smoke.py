#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``vcoder_tpu_torch``) on one GPU.

    python3 chip_smoke.py                  # every phase (1-4, 6, 7, 8, 9, 12, 5, 11a, 10,
                                           # 11, 13, 14, 16, 17, 18, 15)
    python3 chip_smoke.py --profile        # also torch.profiler: two B=1 requests,
                                           # the paged engine's decode step at B=8,
                                           # in bf16, with int4/int8 weights and with
                                           # the fused append, engine C's first turn
                                           # (chunked prefill), and one training step
    python3 chip_smoke.py --faults         # only: K6's gates against faulty builds
                                           # of flash_bwd.cu (K6_FAULTS)

Phases, in order; any failure exits non-zero:

1. Device: the card's name and power limit from ``nvidia-smi``.
2. Build: every ``vcoder_tpu_torch/csrc/*.cu`` with ``nvcc`` for ``sm_90a``,
   one process per source, in parallel, into ``vcoder_tpu_torch/_build/``.
3. Kernels against their plain PyTorch versions at the main path's shapes,
   each with its time, its plain version's time, one PyTorch call
   computing the same function as a yardstick, and its bound: flash
   forward, ViT block, the paged kernel in nineteen cases (``PAGED_CASES``:
   bf16 and int8 decode, bf16 and int8 verify windows of 4, bf16 and int8
   chunk windows (int8 at 2 and 4 rows, bf16 also at pages of 16 and 256,
   a GQA chunk with a length-0 row and a row of 70 tokens, an int8 chunk
   whose live page ids lie past the pool), bf16 and int8 GQA with a
   length-0 row and a window across a page, an unstacked pool, int8 at B=1
   where the split is largest, a row with fewer live pages than the split,
   and int8 at pages of 16, 256 and 8; each logs the body -- SPLIT up to
   16 query columns, TILE past them -- and cluster size it takes; gated on
   max-abs 2e-2 and on the relative L2 of each head's output,
   ``PAGED_REL_L2``),
   the int4 decode matmul (K5) at B=1
   and B=8 over the 7B q/k/v/o, gate/up, down and lm_head weights (timed in
   both forms, with and without the scale epilogue), at B=8 over the local
   shards of a model split of 2 (``INT4_LOCAL``) and in five ragged
   cases, each gated on two bf16 ulps, the scaled form bit-equal to the
   product times the scale and two launches bit-identical, the int8 GEMM in both
   forms at the six W8A8 prefill shapes, two local shards and a ragged one (the s32 form
   exact, the scaled form within one bf16 rounding; timed beside
   ``torch._int_mm`` on the weight as stored and on a K-major copy), and the
   flash backward (K6: the dq kernel, which also computes delta, then the
   dkv kernel) on the rows of phase 8's first batch (B=4, T=2048, H=KH=32,
   right-padded, the output gradient 0 on pad rows), in a GQA case with
   key-mask holes, a row that sees no key and T < S, and on K1's
   non-monotone and ragged layouts, gated on relative L2 per gradient and
   per 64-row tile and on exact zeros where the plain gradient is 0, and
   timed beside SDPA's causal backward over the first L_max rows and keys
   (its flash form) and with the boolean mask; the fused append + attend (K7) in
   ten cases (``FUSED_CASES``: bf16 and int8 pools at windows 1 and 4 at
   the decode shape, bf16 and int8 GQA cases with an inactive row and a
   window across a page, the int8 one also at pages of 16, bf16 verify
   at pages of 128, and bf16 and int8 GQA windows of 8, 32 columns, on the
   TILE body), gated on
   the active rows' outputs as the paged cases, every pool page but the scratch page byte-equal
   to the plain version's and the scratch page holding the inactive rows'
   writes, timed beside the port's unfused route; the tower GEMMs' shared
   mainloop (``csrc/gemm_sm90.cuh``) in one ragged case per epilogue
   (M=200, N=328, K=328: every edge ragged; the bias epilogue also without
   a bias); the ViT block (K2) and the fused ViT MLP (K9) at B=3, T=577,
   Dm=1024, I=4096 (K9 with bf16 and with f32 LN parameters and biases),
   each launch also timed alone (TFLOP/s beside its bound;
   ``repack_block`` beside K2). The tower kernels are gated on relative L2
   (``TOWER_REL_L2``) over the whole output and over its last, ragged
   64-row tile alone, beside max-abs. The flash forward (K1) runs six
   cases, each gated on max-abs 2e-2 and LSE 1e-3 against
   ``flash_attention_ref``: the decoder prefill (timed beside SDPA's causal
   form on its valid rows and beside SDPA with the boolean mask), a GQA case
   with key holes and a row that sees no key, the tower's d64 case (beside
   SDPA with and without its all-True mask), positions that are not
   monotone (a left-padded row, a row permuted within a tile), T and S not
   multiples of 128 in a cached prefill, and the training step's shape
   (phase 8's first batch, B=4, T=2048). Kernels and yardsticks
   are timed by CUDA-graph replay (SDPA's masked backward eagerly, its
   causal backward by its kernels' device time under the profiler), the plain
   versions eagerly. Each serving kernel also runs at the 13B decoder's
   shapes (40 heads of 128, hidden 5120, intermediate 13824), gated as its
   table's cases and noted under ``cases_13b`` on its entry of the kernels
   line: K1's prefill at H=KH=40; K8, K3 (verify w=4, chunk w=128) and K4
   (decode at B=4, 8 and 16, verify w=4) at KH=40 over 40-layer pools
   (``PAGED_CASES_13B``); K7's bf16 and int8 decode (``FUSED_CASES_13B``);
   K5 at B=1, 8 and 16 over the four 13B products (``INT4_SHAPES_13B``);
   K10 in both forms at M=1232 and 1792 over three (``INT8_CASES_13B``);
   and, after the 7B training cases, K1's training shape and K6 on the
   rows of phase 8's first batch at H=KH=40 (``check_training_13b``: the
   7B cases' gates and timings, noted on ``flash_fwd_train`` and
   ``flash_bwd``).
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
   kernel at windows 4 and 128 and hit the prefix cache. Each engine logs
   its served tokens' digest.
7. Quantized weights at full width: the phase-4 weights quantized on the
   card (``quantize_params``) to int4 and int8; the 3 requests of phase 4
   through ``generate`` on the int4 model, gated on 362 W8A8 products
   (``int8_mm_scaled``) and 32 flash launches per prefill, 225
   ``int4_matmul`` launches per decode step plus 1 per prefill, no ViT
   block; engine D (int4 weights, bf16 pools) and E (int8 weights, int8
   pools) on engine A's traffic, gated on the same counts per admission
   and per decode step; each engine's tokens are logged as a digest, beside
   the digest last recorded (``QUANT_DIGESTS``).
8. Training at full width: VCoder-DS-7B's stage-3 adapters (seg and depth
   projectors, ``vcoder_lm_emb``) trained over the phase-4 bf16 base
   through ``Trainer``: 4 steps of B=4 over 20 in-memory DS samples,
   ``remat="dots"``, the trainable leaves cloned first. Gates: finite
   losses and grad norms; non-zero seg-projector and ``vcoder_lm_emb``
   gradients on step 1 and an exactly zero depth-projector gradient; the
   weights unmoved by step 1 (lr 0) and moved by step 2; per step 32 K6
   calls, 64 flash forward launches (32 + 32 recomputed) and 23 ViT-block
   launches, and none of a kernel without a backward; the kernel route's
   trainable gradients within a bound of the plain route's on one sample.
9. Fused kernels and multi-LoRA at full width, over the phase-4 weights:
   engine F is engine A's traffic with ``FUSED_APPEND`` on (gated on 32 K7
   launches per decode step, no K8, and A's first tokens); engine G serves
   int8 pools with ``speculative=4``, ``FUSED_APPEND``, ``FUSE_MLP_DEFAULT``
   and two seeded adapters (rows 3 x ``a``, 3 x ``b``, 2 x none), beside G0,
   the same without adapters (gated on 32 K7 per verify step and no K4, 23
   K9 per admission, G's no-adapter rows equal to G0's, and each adapter
   changing a row's tokens); then phase 4's requests through ``generate``
   with ``FUSE_MLP_DEFAULT`` on (23 K9 per tower pass, prefill logits within
   ``MLP_ROUTE_REL_L2`` of the unfused MLP's). Both flags are restored.
5. The checkpoint entry point: ``save_pretrained`` writes a small DS
   checkpoint, ``load_pretrained_model`` loads it on the card as bf16, with
   ``load_4bit`` and with ``load_8bit``, and as the base of a PEFT LoRA
   directory and of an adapter-only directory (``model_base``), and
   ``generate`` runs on each; their prefill logits through the kernels agree
   with the plain route.
10. Surfaces, on the phase-4 weights and requests (greedy, EOS off):
   every token of ``generate(lookahead=8)``, replayed on the decode path
   with lookahead's own prefix, must be that row's top logit or short of
   it by no more than one bf16 ulp or the spread between two correct
   routes there (decode steps against one forward over the sequence); so
   it equals greedy's tokens up to such a near-tie (each logged with its
   gap; verify dispatches, tokens accepted per dispatch and decode tok/s
   logged beside greedy's);
   ``generate(num_beams=4)`` twice must agree, and ``_beam_generate`` at
   W=1 must equal greedy; ``generate_stream`` at lookahead 0 and 8 must end
   in ``generate``'s text with growing chunks; each gated on 32 flash
   launches per prefill, 23 ViT blocks per tower pass and no paged launch.
   Then ``save_pretrained`` writes the weights with a tokenizer that gives
   every id a word (``full_vocab_tokenizer``) to a temporary
   ``vcoder_ds_llava-v1.5-7b`` directory. The pictures go out as PNGs with
   every row Paeth-filtered (their decode time logged). They are served over
   HTTP by ``server.serve(Chat(dir))`` (one greedy request, default
   lookahead 8, its text equal to ``generate(lookahead=8)``'s)
   and by ``engine_server``'s worker at ``main()``'s defaults (page 128,
   max_len 4096; 4 concurrent requests; gated on 32 K8 launches per decode
   step and 32 flash / 23 ViT per admission), then by the CLI as a
   subprocess (two turns on stdin); every chunk ``error_code`` 0 and every
   surface's first token equal to ``generate``'s. Logs the seconds of each
   load and of the phase, the TTFTs, tok/s and token digests.
11. A COST depth eval (``scripts/v1_5/eval/cost_depth.sh``'s flow) of the
   DS model at full width and depth, in two parts. Before phase 10, on the
   phase-4 weights: a COST-like tree of 8 keys (``make_cost_tree``: the
   repo's JPEG photos, panoptic maps and depth maps, cycled, read as data,
   and a ``panoptic_order.txt``); every JPEG of it decoded by the native
   library on this machine's route (libjpeg, or nvJPEG where libjpeg's
   headers are missing) and held to PIL's decode (``JPEG_REFS``: channel
   means within ``JPEG_MEAN_TOL``, 16x16 box thumbnails within
   ``JPEG_THUMB_TOL`` levels); the 24 files through
   ``load_images_preprocessed`` (milliseconds and routes logged, no file
   through PIL), its PNGs against ``png.decode_png`` + ``process_images``
   (mean below 0.01, 99th percentile below 0.06); each row's first token and
   top-two logit gap from a B=1 prefill. Then, in phase 10's checkpoint
   directory: ``cost_loader.eval_model`` (``--tasks depth --use-seg
   --use-depth --batch-size 8``, greedy, 512 new tokens, one load) and
   ``depth_accuracy`` on its answers file. Gates: 8 records for the 8 keys in
   order and in the record format; each answer starts with its B=1 first
   token, or that row's B=1 top two logits lie within one bf16 ulp (logged);
   32 flash launches per batched prefill, 23 ViT blocks per tower pass, no
   paged launch; one finite DS >= 0 per key. Logs the load seconds, the eval
   wall, tokens/s and ms a step of ``generate``, the answers' sha1 and the DS.
12. The slot engine (``serve/engine.py``'s ``ServingEngine``: a dense KV
   cache per slot) at full width, after phase 9, on the phase-4 weights and
   engine A's traffic (8 requests of 32 tokens, EOS off, all submitted at
   once through ``EngineWorker.from_engine``; ``max_batch`` 8, ``max_len``
   2048): S1 a bf16 cache, S2 an int8 cache (``kv_quant``), S3 S1 with
   ``speculative=4, sync_every=4`` (the fused speculative windows), S4 the
   weights quantized to int8 on the card with an int8 cache. Gates: per
   admission 32 flash launches, 23 ViT blocks on the bf16 tower (0 on the
   quantized one) and 362 scaled int8 GEMMs in S4, no paged launch and no
   other kernel; every S1 and S3 token replayed on ``generate``'s decode
   path under phase 10's rule; S2's prefill logits within
   ``SLOT_PREFILL_REL_L2`` of S1's. Logs each engine's TTFT p50, aggregate
   decode tok/s, step wall p50 and cache bytes.
13. A training stage from files, in phase 10's checkpoint directory after
   phase 11: ``make_train_tree`` writes COST's training layout (three
   buckets, photos, panoptic and depth maps from the repo's pictures,
   ``<task>.txt`` and ``panoptic_order.txt``); ``vcoder_ds_train``'s parser
   and ``run_stage`` train 4 steps of B=4 in this process (and its
   ``--help`` runs as a subprocess). Gates: 4 finite losses, non-zero
   seg-projector and ``vcoder_lm_emb`` gradient norms on every step, per
   step 32 K6 calls, 64 flash launches and 23 ViT blocks and no other
   kernel, and ``adapters.safetensors``, ``checkpoint-4`` and ``final/``
   (``model_type`` ``vcoder_ds_llava``) written (the weight files through
   pipes, below). Logs step ms, valid
   tokens/s, peak memory and the files' decode routes.
14. The first full-LLM stage, after phase 13, with the Adam moments in
   pinned host memory, from a plain-LLaVA ``llava-v1.5-7b`` directory
   beside phase 10's (``write_llava_dir``: a llava config and phase 10's
   weights file hard-linked, of which it reads the tower, ``mm_projector``
   and ``lm``): ``train.train``'s ``main``
   (``scripts/v1_5/train_torch/finetune.sh``'s flow, ``--stage full
   --offload-opt-state``, lr 2e-5) trains 4 steps of B=4 at
   ``--model-max-length 2048`` in this process over a LLaVA-format JSON of
   the repo's photos (``make_llava_json``: six-turn conversations that fill
   the 2048 bucket). Gates: 4 finite losses; non-zero ``lm/`` and
   ``mm_projector`` gradient norms every step; per step 64 K1, 32 K6 and 23
   ViT blocks and no other kernel; every shaped moment in pinned host
   memory and ``count`` on the card; the step checkpoint (every parameter
   and moment), ``adapters.safetensors`` and ``final/`` (``model_type``
   ``llava``, 32 layers) written; and phase 18's memory gates at 7B (the
   state's bytes, the host allocator's holding, host memory, the peak
   estimate), the same function (``full_stage_cli``) running both. Then an
   A/B through ``Trainer`` on the trained
   weights: 2 steps of B=1 with the moments resident, then from the same
   trainable leaves 2 steps offloaded; gated on bit-equal leaves and state
   (``bits_digest``), leaves that moved, the same launch gates, and an
   offloaded peak of allocated memory at least ``MOMENT_CUT`` x the
   moments' bytes below the resident one. Logs step ms, valid tokens/s,
   peak device memory (offloaded and resident), host RSS and pinned bytes,
   and each offloaded step's H2D, D2H and update times on the copy
   streams' events with their overlap.
16. VCoder-DS-13B on the card (``phase_13b``), after phase 14 has
   released every 7B tree: ``VCoderConfig.standard("vcoder_ds_llava",
   "13b")`` at full width and depth (40 decoder layers, 23 CLIP blocks),
   seeded random bf16 weights, EOS off. 16a: phase 4's 3 requests through
   ``generate`` (40 K1 and 23 K2 launches a prefill; TTFT and decode
   logged). 16b: engine A13 (bf16 pools, ``max_batch`` 8) on engine A's
   traffic through ``EngineWorker.from_engine``, gated on 40 K8 launches a
   decode step and 40/23 flash/ViT launches an admission, its tokens beside
   ``generate``'s. 16c: ``save_pretrained`` into a temporary
   ``vcoder_ds_llava-v1.5-13b`` directory (the run's checkpoint writes,
   phase 10's included, reckoned from file sizes and gated on
   ``DISK_BUDGET_GIB``), ``quantize_params(bits=8)`` in place (its peak
   over the bf16 tree gated on ``QUANT_PEAK_GIB``), engine E13 (int8
   weights and pools, ``max_batch`` 4, 4 requests; 418 scaled K10 products
   an admission, 40 K4 launches a step), and E13's B=1 prefill logits with
   W8A8 on against off. 16d: the int8 tree freed,
   ``load_pretrained_model(dir, load_4bit=True)`` (seconds and peak
   logged), engine D13 (int4 weights, int8 pools, ``max_batch`` 16, 16
   requests; 281 K5 a step and 1 an admission, 418 K10, 40 K4); the
   directory is deleted after phase 17 has run in it. One ``phase16:
   {...}`` line holds the readings.
17. VCoder-DS-13B training at full width and depth (``phase_train_13b``),
   in phase 16's directory once D13's tree is freed, over
   ``make_train_tree``'s COST tree, the weight files through pipes (no
   weight file written). 17a: ``vcoder_ds_train``'s parser and
   ``run_stage`` in this process, B=4, ``--model-max-length 2048``,
   ``TRAIN_STEPS_13B`` steps; gated on finite losses, non-zero seg-projector
   and ``vcoder_lm_emb`` gradients and a zero depth-projector gradient every
   step, per step 80 K1, 40 K6 and 23 ViT blocks and no other kernel,
   ``final/`` a 40-layer ``vcoder_ds_llava``, the piped headers, the peak
   at most ``PEAK_ESTIMATE_GIB``, and the kernel route's gradients on the
   trained tree within ``GRAD_ROUTE_REL_L2`` of the plain route's. 17b:
   ``vcoder_it``'s parser and ``run_stage`` with ``vcoder_it_lora.sh``'s
   flags (``--lora-enable``, r 128, alpha 256, lr 2e-4) from a llava-typed
   directory hard-linked beside it, B=``IT_LORA_BATCH`` x accumulation =
   16 rows an update, ``IT_LORA_UPDATES`` updates; gated on finite losses,
   every ``b`` and the seg projector's gradient non-zero on every
   micro-batch, every ``a``'s exactly 0 through the first two updates (the
   first runs at lr 0) and non-zero in the third, two frozen leaves bit for
   bit, per micro-batch 80 K1, 40 K6, 23 ViT blocks and no other kernel,
   the seven products' ``a``/``b`` at rank 128 over 40 layers in
   ``adapters.safetensors``, ``final/`` merged, and the merge's peak over
   what it starts from within the merged weights plus
   ``MERGE_SLACK_GIB``. One ``phase17: {...}`` line holds step ms, valid
   tokens/s, peaks, load and merge seconds.
18. The 13B full-LLM stage (``phase_full_13b``), in phase 16's directory
   after phase 17: ``train.train``'s ``main`` with ``finetune.sh``'s flags
   and ``--offload-opt-state`` from a llava-typed hard link, B=
   ``FULL_BATCH_13B`` (the largest of 4, 2, 1 that fits the card:
   ``scripts/phase18.py --find-full-batch``), ``FULL_STEPS_13B`` (3) steps,
   the weight files through pipes (``full_stage_cli``, as phase 14). The 13.05 B trainable parameters' bf16
   moments (48.6 GiB, ~66 GiB pinned) would not fit the card beside the
   weights and gradients: the offload is what makes the stage run. Gates:
   finite losses, non-zero ``lm/`` and ``mm_projector`` gradients every
   step, per step 80 K1, 40 K6 and 23 ViT blocks and no other kernel,
   every shaped moment pinned and ``count`` on the card, the state's bytes
   equal to the reckoned moments (``full_stage_reckoning``) and the host
   allocator's holding within 1% of its power-of-two reckoning, host memory
   in use below the machine's, the peak at most ``full_peak_estimate_gib``,
   the piped headers, ``final/`` a 40-layer llava, and once the state is
   released its pinned blocks handed back (phase 15's rank needs the host
   memory). One ``phase18: {...}``
   line holds step ms, valid tokens/s, the update passes, pinning and load
   seconds, the peak and the host readings. The same stage over four cards
   (mesh (1, 4, 1), each rank's moments in its own pinned memory) is
   ``scripts/phase18.py --mesh``'s, not this script's.
15. The mesh, last (``phase_sharded``; alone ``scripts/multichip_phase.py``):
   in this process the one-device run on fresh 7B weights (the tower on
   its unfused blocks and the B=1 prefills on the attention route the
   mesh's row shards allow, the routes a mesh takes; beside it a reading of
   A, D and E on the flash route): engine A's traffic, 8
   requests of 16 tokens, through paged engines A (bf16 pools, K8), B
   (int8 pools, K4), V (``speculative=4``, K3) and F (``FUSED_APPEND``,
   K7), the slot engine S1, and D (int4 weights, bf16 pools: K10, K5, K8)
   and E (int8 weights and pools: K10, K4) over the weights quantized
   whole leaf by leaf, then phase 8's stage and a ``lora`` stage (rank
   128, alpha 256, over every decoder product), each 4 steps at a global
   B=4. Before it, on the card, ``check_row_split``: the row-parallel
   products of a model split of 2 (bf16, the int8 upcast and K5 as f32
   partials, W8A8 through K10's s32 form with the absmax of both halves)
   against one device's. Then the ranks, one process per card through
   ``parallel/launch.spawn`` over NCCL (four cards mesh (1, 2, 2), two
   (1, 1, 2), one card a one-rank group: two gloo ranks on one card crash
   in DTensor's all-gather), each building the same weights and keeping
   its shards, run the same. Gates: equal tokens and losses on every rank;
   prefill logits within ``SHARDED_LOGIT_REL_L2`` of the one-device run
   and every first token equal; each loss within ``SHARDED_LOSS_REL``,
   each trained leaf's gradient norm within ``SHARDED_NORM_REL``; two frozen
   weights' shards unchanged; per rank 64 K1 and 32 K6 a training step,
   32 launches of the engine's paged kernel a decode dispatch, K5 and K10
   (both forms) as many as on one device, no K2/K9; the build and the
   quantization within their memory bounds. Logs the gaps, the share of
   equal later tokens, step times against the one-device run and each
   rank's peak memory.

The card machine's disk takes ~45 GiB of writes a run (deleted files
count); phase 10's directory takes 13.5 of them and phase 16's 13B
directory ~25: phases 13, 14, 17 and 18 write
their weight files (step checkpoint, adapters, ``final/model.safetensors``)
into pipes, in-process sinks that check each header and byte count and
write nothing (``piped_weights``); their small files are written as files.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import shutil
import struct
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


def note_case(report: list, kernel: str, case: str, row: dict) -> None:
    """A further case of ``kernel`` at another configuration's shapes (the
    13B decoder's): its numbers go on the kernel's entry of the
    ``{"kernels": ...}`` line, under ``cases_13b``, beside the main case."""
    entry = next(e for e in report if e["name"] == kernel)
    entry.setdefault("cases_13b", []).append(dict(case=case, **row))


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
                dead_row=False, layout=None, seed=0):
    """Inputs for one flash-attention comparison; returns a dict. With
    ``layout`` (positions [B,T] and key mask [B,S], numpy int32) the rows are
    those given and q/k/v are drawn on the card (numpy takes seconds for
    ~100 M normals)."""
    import torch

    rng = np.random.RandomState(seed)
    dev = "cuda"
    if layout is not None:
        pos, mask = (np.ascontiguousarray(a, np.int32) for a in layout)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    else:
        def randn(*shape):
            return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, torch.bfloat16)

    q, k, v = randn(B, T, H, D), randn(B, S, KH, D), randn(B, S, KH, D)
    if layout is None:
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
    # A boolean mask keeps SDPA off its flash backend: where the mask hides
    # nothing, time SDPA without one too (the yardstick for that case); where
    # every row's first n queries sit at positions 0..n-1 over the first n
    # keys and the rest is padding, SDPA's causal form on those n rows computes
    # the same function on them (the yardstick for that case).
    flash_note, flash_ms = "", None
    if not causal and bool(mask.all()):
        flash_ms = graph_ms([lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=(H != KH))] * 5)
        flash_note = f"  sdpa without the mask {flash_ms:.4f} ms"
    n = _causal_prefix(case)
    if n:
        qn, kn, vn = (x[:, :n].transpose(1, 2) for x in (q, k, v))
        flash_ms = graph_ms([lambda: F.scaled_dot_product_attention(
            qn, kn, vn, is_causal=True, enable_gqa=(H != KH))] * 5)
        flash_note = f"  sdpa is_causal on the {n} valid rows {flash_ms:.4f} ms"
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
    log(f"  {case['name']}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms"
        f"{flash_note}  bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    if case.get("note"):
        note_case(report, case["note"], case["name"], dict(
            max_abs_err=err, lse_err=lse_err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms if flash_ms is None else flash_ms,
            library_masked_ms=lib_ms))
    if not case.get("report"):
        return
    report.append(dict(name=case["report"], route="cuda",
                       source="vcoder_tpu_torch/csrc/flash_fwd.cu",
                       replaces="vcoder_tpu/ops/flash_attention.py:216",
                       launches=0, max_abs_err=err, lse_err=lse_err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by,
                       library_ms=lib_ms if flash_ms is None else flash_ms,
                       library_masked_ms=lib_ms, status="ok"))


def _causal_prefix(case: dict) -> int:
    """n when, in every row of a causal case, queries 0..n-1 sit at positions
    0..n-1, exactly keys 0..n-1 are valid and the other queries are padding;
    else 0."""
    n = _causal_prefix_max(case)
    return n if n and (case["np_mask"].sum(axis=1) == n).all() else 0


def _causal_prefix_max(case: dict) -> int:
    """L_max, the longest row, when every row of a causal case is a
    right-padded prefix: its first n queries at positions 0..n-1 over
    exactly keys 0..n-1 (n may differ between rows), the rest padding; else
    0. SDPA's causal form over the first L_max rows and keys of every
    sequence then covers each row's visible pairs (and, in the shorter rows,
    more)."""
    if not case["causal"]:
        return 0
    pos, mask = case["np_pos"], case["np_mask"]
    lens = mask.sum(axis=1)
    for p, m, n in zip(pos, mask, lens):
        if not (0 < n <= pos.shape[1] and (m[:n] == 1).all() and (m[n:] == 0).all()
                and (p[:n] == np.arange(n)).all()):
            return 0
    return int(lens.max())


def _flash_bwd_case(name, B, T, S, H, KH, *, layout=None, holes=False, dead_row=False, seed=0):
    """Inputs for one flash-backward comparison: causal, D=128, and the
    output gradient ``dout``. With ``layout`` (the positions [B,T] and key
    mask [B,S] of a training batch, :func:`training_layout`, or of
    :func:`_flash_edge_layouts`) the rows are those given, and where T == S
    ``dout`` is 0 on the rows whose own key is hidden (a training batch's
    right-padded rows at position 0, as the loss leaves them); q/k/v are
    drawn on the card (numpy takes seconds for ~100 M normals). Otherwise
    the layout of :func:`_flash_case`, with ``dout`` drawn on every row."""
    import torch

    case = _flash_case(name, B, T, S, H, KH, 128, causal=True, holes=holes,
                       dead_row=dead_row, layout=layout, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    dout = torch.randn(case["q"].shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    if layout is not None and T == S:  # query row t is valid where key t is
        dout *= case["mask"][:, :T, None, None].to(dout.dtype)
    case["dout"] = dout
    return case


# K6 against its plain version. Both round P and dS to bf16 at the same
# places but sum in f32 in other orders (and exp differs in the last ulp),
# so an element on a rounding boundary may land one bf16 step apart. Gates,
# for each of dq, dk and dv: max-abs error within 2e-2 of the gradient's
# largest magnitude (at least 2e-2); the relative L2 of the whole gradient; the
# worst relative L2 of one 64-row tile (a query tile of one head for dq, a
# key tile of one KV head for dk and dv: a block's output, so a tile the
# kernel got wrong cannot hide under the norm of the others); and where the
# plain version's row (one head's D values) is all zero -- pad rows, masked
# keys, a row that sees no key -- the kernel's stays below 1e-4 of the
# gradient's largest magnitude. (A row that sees one key has dq = 0 in exact
# arithmetic, but dP and delta are summed in other orders, so the kernel
# reads rounding noise there.)
K6_MAX_ABS = 2e-2
K6_REL_L2 = 1e-3
K6_TILE_REL_L2 = 1e-2
K6_ZERO_ROW = 1e-4


def flash_bwd_agreement(got, ref) -> dict:
    """The readings of the K6 gates for (dq, dk, dv) against the plain
    version's, and ``ok``: every gate held and every value is finite."""
    import torch
    import torch.nn.functional as F

    out, ok = {}, True
    for nm, a, r in zip(("dq", "dk", "dv"), got, ref):
        a, r = a.float(), r.float()
        d = (a - r).square()
        rel = (d.sum() / r.square().sum().clamp_min(1e-30)).sqrt().item()
        B, N, Hx, D = r.shape
        pad = (-N) % 64

        def tiles(x):  # [B, N, Hx, D] -> per (batch, 64-row tile, head) sums
            return F.pad(x, (0, 0, 0, 0, 0, pad)).reshape(B, -1, 64, Hx, D).sum(dim=(2, 4))

        dt, rt = tiles(d), tiles(r.square())
        live = rt > 0
        worst = (dt[live] / rt[live]).sqrt().max().item() if bool(live.any()) else 0.0
        top = r.abs().max().item()
        zero_rows = r.abs().amax(-1) == 0
        stray = a.abs().amax(-1)[zero_rows].max().item() if bool(zero_rows.any()) else 0.0
        finite = bool(torch.isfinite(a).all())
        err = (a - r).abs().max().item()
        max_abs_ok = err <= K6_MAX_ABS * max(1.0, top)
        good = (max_abs_ok and rel <= K6_REL_L2 and worst <= K6_TILE_REL_L2
                and stray <= K6_ZERO_ROW * max(top, 1e-30) and finite)
        out[nm] = dict(rel_l2=rel, worst_tile_rel_l2=worst, zero_row_max=stray,
                       max_abs_err=err, max_ref=top, max_abs_ok=max_abs_ok, finite=finite,
                       ok=good)
        ok &= good
    out["ok"] = ok
    return out


def _log_agreement(name: str, agree: dict) -> None:
    for nm in ("dq", "dk", "dv"):
        r = agree[nm]
        log(f"kernel {name}: {nm} rel L2 {r['rel_l2']:.3e} (tol {K6_REL_L2}), worst 64-row "
            f"tile {r['worst_tile_rel_l2']:.3e} (tol {K6_TILE_REL_L2}), largest value in the "
            f"plain version's zero rows {r['zero_row_max']:.3e} (tol {K6_ZERO_ROW} of max|ref|), "
            f"max_abs_err {r['max_abs_err']:.3e} (tol {K6_MAX_ABS} of max|ref| "
            f"{r['max_ref']:.3f}) -> {'ok' if r['ok'] else 'FAIL'}")


def _device_ms(fn, names: tuple, reps: int = 5) -> dict:
    """Device ms per call of ``fn`` of each kernel whose name contains one
    of ``names`` (``""``: every kernel), summed from ``torch.profiler``'s
    CUDA events over ``reps`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {n: 0.0 for n in names}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for n in names:
                if n in e.name:
                    out[n] += e.time_range.elapsed_us() / 1e3 / reps
    return out


def check_flash_bwd(case: dict, report: list) -> None:
    """K6 against its plain version on one case: dq, dk and dv of the
    backward pair (the dq kernel, then the dkv kernel) under the gates of
    :func:`flash_bwd_agreement`; with ``case["report"]`` also the pair's
    time, each kernel's under the profiler, the plain version's, the plain
    delta pass the dq kernel replaced, and SDPA's backward in its flash form
    (``is_causal`` over the first L_max rows and keys) and with the boolean
    mask; with ``case["note"]`` the same readings noted on the ``flash_bwd``
    entry (:func:`note_case`)."""
    import torch
    import torch.nn.functional as F

    from vcoder_tpu_torch.ops import flash_attention as fa

    q, k, v, pos, mask, dout = (case[x] for x in ("q", "k", "v", "pos", "mask", "dout"))
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    scale = D**-0.5
    out, lse = fa.launch_flash_fwd(q, k, v, pos, mask, causal=True, scale=scale)
    run = lambda: fa.launch_flash_bwd(q, k, v, out, lse, dout, pos, mask,
                                      causal=True, scale=scale)
    got = run()
    ref = fa.flash_bwd_ref(q, k, v, out, lse, dout, pos, mask, causal=True)
    torch.cuda.synchronize()
    agree = flash_bwd_agreement(got, ref)
    _log_agreement(case["name"], agree)
    if not agree["ok"]:
        raise SystemExit(f"{case['name']}: flash backward disagrees with its plain version")
    if not case.get("report"):
        return
    ms = graph_ms([run] * 3)
    split = _device_ms(run, ("flash_bwd_dq", "flash_bwd_dkv"))
    # The plain-torch delta the dq kernel's prologue replaced (four launches).
    delta_torch_ms = cuda_ms(
        lambda: (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous(), iters=10)
    plain_ms = cuda_ms(lambda: fa.flash_bwd_ref(q, k, v, out, lse, dout, pos, mask, causal=True),
                       iters=2, warmup=1)
    # Yardsticks, timed only: SDPA's backward on the same inputs with the
    # boolean mask (which keeps SDPA off its flash backend), and where the
    # rows are right-padded prefixes, its flash form: is_causal over the
    # first L_max rows and keys of every sequence.
    kpos = torch.arange(S, device="cuda")
    bmask = (mask[:, None, :].bool() & (kpos[None, None, :] <= pos[:, :, None]))[:, None]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bmask, enable_gqa=(H != KH))
    do_t = dout.transpose(1, 2)
    lib_masked_ms = cuda_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), do_t, retain_graph=True),
                            iters=3, warmup=1)
    del o, qt, kt, vt
    lib_ms, flash_note = lib_masked_ms, ""
    n = _causal_prefix_max(case)
    if n:
        qn, kn, vn = (x[:, :n].transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        o = F.scaled_dot_product_attention(qn, kn, vn, is_causal=True, enable_gqa=(H != KH))
        do_n = dout[:, :n].transpose(1, 2)
        # Its kernels' device time: timed eagerly, the call read 0.43 to
        # 1.24 ms across runs (the host enqueues its kernels slower than
        # they run).
        lib_ms = _device_ms(
            lambda: torch.autograd.grad(o, (qn, kn, vn), do_n, retain_graph=True), ("",), 10)[""]
        del o, qn, kn, vn
        flash_note = (f"  sdpa backward is_causal on the first {n} rows and keys of every "
                      f"sequence (the flash form; a superset of each row's visible pairs; its "
                      f"kernels' device time) {lib_ms:.4f} ms")
    # Work these inputs need: five 2*D products over each visible (query,
    # key) pair of each head; q, k, v, out, dout, lse, positions and mask
    # read once, dq, dk and dv written once.
    vis = (case["np_mask"][:, None, :].astype(bool)
           & (np.arange(S)[None, None, :] <= case["np_pos"][:, :, None]))
    pairs = float(vis.sum()) * H
    flops = 10.0 * D * pairs
    nbytes = (2 * 4 * (B * T * H * D + B * S * KH * D)  # q out dout dq, k v dk dv
              + B * H * T * 4 + B * T * 4 + B * S * 4)
    b_ms, b_by = bound(flops, nbytes)
    log(f"  {case['name']}: kernels {ms:.4f} ms (under the profiler: dq with delta "
        f"{split['flash_bwd_dq']:.4f}, dkv {split['flash_bwd_dkv']:.4f}; the plain-torch delta "
        f"it replaced {delta_torch_ms:.4f})  plain {plain_ms:.4f} ms  sdpa backward with the "
        f"boolean mask {lib_masked_ms:.4f} ms{flash_note}  bound {b_ms:.4f} ms ({b_by}; "
        f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e6:.1f} MB)")
    row = dict(max_abs_err=max(agree[nm]["max_abs_err"] for nm in ("dq", "dk", "dv")),
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               library_masked_ms=lib_masked_ms, dq_ms=split["flash_bwd_dq"],
               dkv_ms=split["flash_bwd_dkv"], delta_torch_ms=delta_torch_ms)
    if case.get("note"):
        note_case(report, "flash_bwd", case["name"], row)
        return
    report.append(dict(name="flash_bwd", route="cuda",
                       source="vcoder_tpu_torch/csrc/flash_bwd.cu",
                       replaces="vcoder_tpu/ops/flash_attention.py:446",
                       launches=0, **row, status="ok"))


def _k6_cases(layout):
    """Phase 3's four K6 cases: the training step's first batch (``layout``),
    the GQA case, and K1's two edge layouts (non-monotone positions; ragged
    T and S with a key hole), which reach both sides of the mask-free and
    skip decisions of both kernels."""
    pos, mask = layout
    B, T = pos.shape
    lens = [int(n) for n in np.asarray(mask).sum(axis=1)]
    yield _flash_bwd_case(f"flash_bwd B={B} T={T} H=KH=32 rows {lens}", B, T, T, 32, 32,
                          layout=layout, seed=5)
    yield _flash_bwd_case("flash_bwd GQA 32q/8kv, kv_mask holes, a fully-masked row, S>T",
                          2, 200, 333, 32, 8, holes=True, dead_row=True, seed=6)
    for seed, (label, H, KH, (p, m)) in zip((7, 8), _flash_edge_layouts()):
        yield _flash_bwd_case(f"flash_bwd {label}", p.shape[0], p.shape[1], m.shape[1], H, KH,
                              layout=(p, m), seed=seed)


def phase_flash_bwd_kernels(report: list, layout) -> None:
    """K6 against its plain version at the training step's shape -- the
    rows of the first batch phase 8's ``Trainer`` collates (B=4, T its
    bucket, H=KH=32, right-padded rows of different lengths) -- in a GQA
    case (H=32, KH=8) with key-mask holes, a row that sees no key and T < S,
    and on K1's non-monotone and ragged layouts."""
    import torch

    from vcoder_tpu_torch.ops import flash_attention as fa

    for i, case in enumerate(_k6_cases(layout)):
        case["report"] = i == 0
        check_flash_bwd(case, report)
        del case
        torch.cuda.empty_cache()
    fa.launches = fa.bwd_launches = 0  # comparison launches do not count


# Faults planted in copies of csrc/flash_bwd.cu for ``--faults``: each
# replaces one line of the source. The K6 gates must fail every one.
K6_FAULTS = {
    "dkv skips query tile 1": (
        "const bool tile_seen = __any_sync(0xffffffffu, ok);",
        "const bool tile_seen = __any_sync(0xffffffffu, ok) && tile != 1;"),
    "dkv skips the diagonal query tiles of the key blocks from 1024 on": (
        "const bool tile_seen = __any_sync(0xffffffffu, ok);",
        "const bool tile_seen = __any_sync(0xffffffffu, ok) && !(kv0 >= 1024 && "
        "tile * L::BQ >= kv0 && tile * L::BQ < kv0 + L::BK);"),
    "dkv drops each key's own query row (< for <=)": (
        "const bool ok = kok[e >> 1] && (!causal || key[e >> 1] <= pc[e & 1]);",
        "const bool ok = kok[e >> 1] && (!causal || key[e >> 1] < pc[e & 1]);"),
    "dq skips key tile 1": (
        "*reinterpret_cast<uint4*>(m) = make_uint4(w0, w1, (w0 & w1) == 0xffffffffu, 0u);",
        "*reinterpret_cast<uint4*>(m) = make_uint4(j == 1 ? 0u : w0, j == 1 ? 0u : w1, "
        "j != 1 && (w0 & w1) == 0xffffffffu, 0u);"),
    "dq judges a key tile mask-free one tile early": (
        "const bool clean = mw[2] != 0 && (!causal || kv0 + L::BK - 1 <= warp_min);",
        "const bool clean = mw[2] != 0 && (!causal || kv0 - 1 <= warp_min);"),
}


def build_k6_faults(tmp: str) -> dict:
    """One library per fault of ``K6_FAULTS``, built in parallel from a
    changed copy of ``flash_bwd.cu`` in ``tmp``; returns {fault: library}."""
    from pathlib import Path

    from vcoder_tpu_torch.ops import _kernels

    src = (_kernels.SRC_DIR / "flash_bwd.cu").read_text()
    procs = {}
    for i, (label, (old, new)) in enumerate(K6_FAULTS.items()):
        if src.count(old) != 1:
            raise SystemExit(f"fault {label!r}: its line is not in flash_bwd.cu exactly once")
        cu, so = Path(tmp) / f"fault{i}.cu", Path(tmp) / f"libfault{i}.so"
        cu.write_text(src.replace(old, new))
        procs[label] = (subprocess.Popen(_kernels.nvcc_command(cu, so), stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for label, (proc, so) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for fault {label!r}:\n{text}")
        libs[label] = _kernels.load("flash_bwd", so)
    return libs


@contextlib.contextmanager
def k6_library(cdll):
    """``launch_flash_bwd`` runs ``cdll`` (a faulty build) inside the block."""
    from vcoder_tpu_torch.ops import _kernels

    real = _kernels.lib("flash_bwd")
    _kernels._LIBS["flash_bwd"] = cdll
    try:
        yield
    finally:
        _kernels._LIBS["flash_bwd"] = real


def phase_k6_faults(layout, ds) -> bool:
    """``--faults``: every fault of ``K6_FAULTS`` through phase 3's K6 cases
    (each must fail the gates, which the sound kernel passes), then through
    phase 8's kernel-route check on the 7B weights (a reading of what that
    gate can see). Returns True when the K6 gates passed the sound kernel in
    both cases and failed every fault in at least one (the late-tile fault
    has nothing to change in the GQA case)."""
    import torch

    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.train.step import trainable_leaves

    failed, summary = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_k6_faults(tmp)
        for case in _k6_cases(layout):
            q, k, v, pos, mask, dout = (case[x] for x in ("q", "k", "v", "pos", "mask", "dout"))
            out, lse = fa.launch_flash_fwd(q, k, v, pos, mask, causal=True,
                                           scale=q.shape[-1] ** -0.5)
            ref = fa.flash_bwd_ref(q, k, v, out, lse, dout, pos, mask, causal=True)
            for label, cdll in [("sound", None)] + list(libs.items()):
                with k6_library(cdll) if cdll is not None else contextlib.nullcontext():
                    got = fa.launch_flash_bwd(q, k, v, out, lse, dout, pos, mask, causal=True,
                                              scale=q.shape[-1] ** -0.5)
                torch.cuda.synchronize()
                agree = flash_bwd_agreement(got, ref)
                # For comparison: what the max-abs gate alone would say.
                former = all(agree[nm]["max_abs_ok"] for nm in ("dq", "dk", "dv"))
                _log_agreement(f"{case['name']} [{label}]", agree)
                log(f"  [{label}] K6 gates {'pass' if agree['ok'] else 'fail'}; the max-abs "
                    f"gate alone would {'pass' if former else 'fail'}")
                failed[label] = failed.get(label, False) or not agree["ok"]
                summary.setdefault(label, []).append(dict(
                    case=case["name"], gates_pass=agree["ok"], former_gate_pass=former,
                    **{nm: {x: agree[nm][x] for x in ("rel_l2", "worst_tile_rel_l2",
                                                      "zero_row_max")}
                       for nm in ("dq", "dk", "dv")}))
            del case, q, k, v, out, lse, ref, got
            torch.cuda.empty_cache()

        cfg, params, model, _ = build_model()
        del model
        stage = "vcoder_ds"
        for t in trainable_leaves(params, stage).values():
            t.requires_grad_(True)
        T = layout[0].shape[1]
        plain = None
        for label, cdll in [("sound", None)] + list(libs.items()):
            with k6_library(cdll) if cdll is not None else contextlib.nullcontext():
                r = route_agreement(cfg, params, ds, T, stage, plain)
            plain, rel = r["plain"], r["rel"]
            summary[label].append(dict(case="route", rel_l2=rel, per_leaf=r["per_leaf"],
                                       loss_kernel=r["loss_kernel"], loss_plain=r["loss_plain"],
                                       route_gate_pass=rel <= GRAD_ROUTE_REL_L2))
            log(f"  [{label}] phase-8 route: trainable gradients rel L2 {rel:.3e} -> the "
                f"{GRAD_ROUTE_REL_L2} gate would {'pass' if rel <= GRAD_ROUTE_REL_L2 else 'fail'}")
    log("faults: " + json.dumps(summary))
    return not failed.pop("sound") and all(failed.values())


# The tower GEMMs' gates (K2, K9 and the ragged cases): relative L2 of the
# whole output and of its last, ragged row tile (the mainloop's 64 rows) on
# its own, beside max-abs. A stale stage or a wrong descriptor moves whole
# tiles; bf16 roundings in another f32 order move the relative L2 by ~1e-3.
TOWER_REL_L2 = 4e-3
TILE_ROWS = 64


def tower_agreement(got, ref) -> dict:
    """max-abs, relative L2 and the last row tile's relative L2 of ``got``
    against ``ref``, both viewed as [rows, columns]."""
    g = got.float().reshape(-1, got.shape[-1])
    r = ref.float().reshape(-1, ref.shape[-1])
    rows = g.shape[0]
    t0 = (rows - 1) // TILE_ROWS * TILE_ROWS

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()

    return dict(max_abs=(g - r).abs().max().item(), scale=r.abs().max().item(),
                rel_l2=rel(g, r), tail_rel_l2=rel(g[t0:], r[t0:]), tail_rows=rows - t0,
                finite=bool(g.isfinite().all()))


def check_tower_gates(name: str, got, ref, abs_tol: float) -> dict:
    a = tower_agreement(got, ref)
    ok = (a["finite"] and a["max_abs"] <= abs_tol and a["rel_l2"] <= TOWER_REL_L2
          and a["tail_rel_l2"] <= TOWER_REL_L2)
    log(f"kernel {name}: max_abs_err {a['max_abs']:.3e} (tol {abs_tol:.3e}, max|ref| "
        f"{a['scale']:.3f}) rel L2 {a['rel_l2']:.3e}, last {a['tail_rows']}-row tile "
        f"{a['tail_rel_l2']:.3e} (tol {TOWER_REL_L2}) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    return a


def _tflops(flops: float, ms: float) -> str:
    b_ms, _ = bound(flops, 0)
    return f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, bound {b_ms:.4f} ms)"


def check_tower_gemms() -> None:
    """The shared GEMM mainloop alone, one ragged case per epilogue (and the
    bias epilogue without a bias): M=200 (the last row tile 8 rows), N=328
    (the last column tile 72 columns: one 64-column box cut short, two wholly
    past N), K=328 (not a multiple of the 64-deep stage), against f32
    products rounded once."""
    import torch

    from vcoder_tpu_torch.ops import vit_attention as va

    M, N, K = 200, 328, 328
    rng = np.random.RandomState(7)

    def randn(*shape, s=1.0, dt=torch.bfloat16):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32)).to("cuda", dt)

    a, w = randn(M, K), randn(K, N, s=0.1)
    bias, res = randn(N, s=0.5, dt=torch.float32), randn(M, N)
    bias16 = bias.to(torch.bfloat16)
    acc = a.float() @ w.float()
    cases = {
        "bias": (lambda o: va.launch_gemm_bias(a, w, bias, o), acc + bias),
        "no bias": (lambda o: va.launch_gemm_bias(a, w, None, o), acc),
        "bias + quick-GELU": (lambda o: va.launch_mlp_gemm(a, w, bias, None, o, gelu=True),
                              (acc + bias) * torch.sigmoid(1.702 * (acc + bias))),
        "residual + bf16 bias": (lambda o: va.launch_mlp_gemm(a, w, bias16, res, o, gelu=False),
                                 (res.float() + acc) + bias16.float()),
    }
    for label, (run, ref) in cases.items():
        out = torch.full((M, N), float("nan"), dtype=torch.bfloat16, device="cuda")
        run(out)
        torch.cuda.synchronize()
        ref = ref.to(torch.bfloat16)
        # One bf16 rounding of f32 sums taken in another order: two ulps at
        # the largest output.
        check_tower_gates(f"tower GEMM {label} M={M} N={N} K={K}", out, ref,
                          2.0 ** -7 * max(1.0, ref.float().abs().max().item()))


def check_vit_block(report: list) -> None:
    import torch
    import torch.nn.functional as F

    from vcoder_tpu_torch.ops import vit_attention as va
    from vcoder_tpu_torch.ops.flash_attention import launch_flash_fwd

    B, T, Dm, H = 3, 577, 1024, 16
    dh = Dm // H
    M = B * T
    rng = np.random.RandomState(1)

    def randn(*shape, s=1.0):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32)).to(
            "cuda", torch.bfloat16)

    layer = {n: randn(Dm, Dm, s=0.03) for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    layer.update({n: randn(Dm, s=0.1) for n in ("q_bias", "k_bias", "v_bias")})
    x = randn(B, T, Dm)
    wqkv, bqkv, wo = va.repack_block(layer, H)
    y = va.fused_block_attention(x, wqkv, bqkv, wo, n_heads=H)
    va.launches = 0  # comparison launches do not count
    ref = va.fused_block_attention_ref(x, wqkv, bqkv, wo, n_heads=H)
    torch.cuda.synchronize()
    # bf16 rounding of qkv, P and o, relative to |y|.
    agree = check_tower_gates("vit_block", y, ref,
                              2e-2 * max(1.0, ref.float().abs().max().item()))
    ms = graph_ms([lambda: va.fused_block_attention(x, wqkv, bqkv, wo, n_heads=H)] * 5)
    va.launches = 0
    plain_ms = cuda_ms(lambda: va.fused_block_attention_ref(x, wqkv, bqkv, wo, n_heads=H),
                       iters=5)
    bq = bqkv.to(torch.bfloat16)

    def library():
        qkv = torch.addmm(bq, x.view(M, Dm), wqkv).view(B, T, 3, H, dh)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        o = F.scaled_dot_product_attention(q, k, v, scale=1.0)
        return o.transpose(1, 2).reshape(M, Dm) @ wo

    lib_ms = graph_ms([library] * 5)
    # The three launches apart, each beside its bound and cuBLAS's product.
    qkv = torch.empty((B, T, 3, H, dh), dtype=torch.bfloat16, device="cuda")
    va.launch_gemm_bias(x.view(M, Dm), wqkv, bqkv, qkv.view(M, 3 * Dm))
    o, _ = launch_flash_fwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], None, None,
                            causal=False, scale=1.0)
    out = torch.empty((M, Dm), dtype=torch.bfloat16, device="cuda")
    qkv_ms = graph_ms([lambda: va.launch_gemm_bias(x.view(M, Dm), wqkv, bqkv,
                                                   qkv.view(M, 3 * Dm))] * 5)
    flash_ms = graph_ms([lambda: launch_flash_fwd(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                                  None, None, causal=False, scale=1.0)] * 5)
    out_ms = graph_ms([lambda: va.launch_gemm_bias(o.view(M, Dm), wo, None, out)] * 5)
    lib_qkv_ms = graph_ms([lambda: torch.addmm(bq, x.view(M, Dm), wqkv)] * 5)
    lib_out_ms = graph_ms([lambda: o.view(M, Dm) @ wo] * 5)
    repack_ms = graph_ms([lambda: va.repack_block(layer, H)] * 5)
    f_qkv, f_out = 2.0 * M * Dm * 3 * Dm, 2.0 * M * Dm * Dm
    flops = f_qkv + 4.0 * B * H * T * T * dh + f_out
    nbytes = M * Dm * 2 * 2 + 4 * Dm * Dm * 2 + 3 * Dm * 4
    b_ms, b_by = bound(flops, nbytes)
    log(f"  vit_block: kernels {ms:.4f} ms  plain {plain_ms:.4f} ms  addmm+sdpa+mm {lib_ms:.4f} ms  "
        f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    log(f"    QKV GEMM {_tflops(f_qkv, qkv_ms)}, cuBLAS addmm {lib_qkv_ms:.4f} ms; flash d64 "
        f"{flash_ms:.4f} ms; out GEMM {_tflops(f_out, out_ms)}, cuBLAS mm {lib_out_ms:.4f} ms; "
        f"the two GEMMs {_tflops(f_qkv + f_out, qkv_ms + out_ms)}; repack_block {repack_ms:.4f} ms")
    report.append(dict(name="vit_block", route="cuda",
                       source="vcoder_tpu_torch/csrc/gemm_bias.cu",
                       replaces="vcoder_tpu/ops/vit_attention.py:52",
                       launches=0, max_abs_err=agree["max_abs"], rel_l2=agree["rel_l2"],
                       ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                       gemm_ms=qkv_ms + out_ms, flash_ms=flash_ms, repack_ms=repack_ms,
                       status="ok"))


def _paged_case(name, *, B, window, H, KH, lengths, L=32, layer=17, page=64, quant=False,
                stacked=True, seed=0, bad_ids=False):
    """Inputs for one paged-attention comparison: pools of L layers (or one
    unstacked layer), each row's live pages drawn without replacement from
    pages 1..n-2 (the sentinel and scratch pages are never allocated), table
    entries past a row's pages pointing at the sentinel. ``bad_ids``: the
    second live page of row 0 and the third of the last row get ids past
    either end of the pool, which the kernel clips to its first or last
    page."""
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
    if bad_ids:
        table[0, 1], table[B - 1, 2] = n_pages + 5, -3
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
    idx = case["table"][:, : int(n_live.max())].long().clamp(0, kp.shape[0] - 1)  # [B, P]

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


def paged_split(case: dict, fused: bool = False) -> tuple:
    """The kernel's ``(body, cluster)`` for ``case`` (``split_of``)."""
    from vcoder_tpu_torch.ops import paged_attention as pa

    return pa.split_of(case["q"], case["kp"].shape[-3], case["table"].shape[1],
                       quant=case["quant"], fused=fused)


def _body(route: tuple) -> str:
    from vcoder_tpu_torch.ops import paged_attention as pa

    body, cluster = route
    return f"{'SPLIT' if body == pa.BODY_SPLIT else 'TILE'} body, cluster of {cluster}"


def paged_runs(case: dict):
    """The kernel's and the plain version's calls on ``case``."""
    from vcoder_tpu_torch.ops import paged_attention as pa

    q, kp, vp, ks, vs = (case[x] for x in ("q", "kp", "vp", "ks", "vs"))
    table, lengths, layer, window = case["table"], case["lengths"], case["layer"], case["window"]
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
    return run, plain


# The paged kernels' gates against the plain version (K3, K4, K7, K8):
# max-abs 2e-2, and the relative L2 of each (row, token, head) output
# vector of 128 dims, worst over the vectors. The outputs are bf16 softmax
# averages whose size falls with the context (about 0.05 over ~1200 keys,
# O(1) over tens), so max-abs alone is loose at decode lengths; the
# relative L2 is not. The TILE body rounds p against the running maxima
# of 64-key tiles (at 64-token pages the plain version's per-page maxima)
# and differs in f32 summation order; the SPLIT body rounds p against each
# warp's running maximum of its split (one bf16 rounding of p, 2**-9
# relative, either way); both then round the output
# to bf16, so two outputs differ by a bf16 ulp (2**-8 relative) in a few
# elements of a vector: a worst head at up to 5.0e-3 on an H100 over
# these cases, where losing one key of ~1200 moves a head by ~3%. A vector
# the plain version leaves 0 (a length-0 row) must be 0.
PAGED_MAX_ABS = 2e-2
PAGED_REL_L2 = 8e-3


def attn_gaps(out, ref) -> tuple:
    """(max-abs error, worst relative L2 of an output vector over its last
    dim) of ``out`` against ``ref``; a vector with ``ref`` 0 counts 0 when
    ``out`` is 0 there too, else inf."""
    import torch

    d = out.float() - ref.float()
    num, den = d.norm(dim=-1), ref.float().norm(dim=-1)
    rel = torch.where(den > 0, num / den.clamp_min(1e-30),
                      torch.where(num > 0, torch.full_like(num, float("inf")),
                                  torch.zeros_like(num)))
    return d.abs().max().item(), rel.max().item()


def paged_agreement(case: dict) -> dict:
    """The kernel against its plain version on ``case``: max-abs error, the
    worst relative L2 of an output vector, finiteness, and ``ok`` within
    the gates."""
    import torch

    run, plain = paged_runs(case)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err, rel = attn_gaps(out, ref)
    ok = (err <= PAGED_MAX_ABS and rel <= PAGED_REL_L2
          and bool(torch.isfinite(out.float()).all().item()))
    return dict(ok=ok, max_abs=err, tol=PAGED_MAX_ABS, rel_l2=rel, rel_tol=PAGED_REL_L2)


def check_paged(case: dict, report: list) -> None:
    import torch
    import torch.nn.functional as F

    q, kp, vp = case["q"], case["kp"], case["vp"]
    table, window = case["table"], case["window"]
    B, k, H, D = q.shape
    run, plain = paged_runs(case)
    agree = paged_agreement(case)
    err, tol, ok = agree["max_abs"], agree["tol"], agree["ok"]
    route = paged_split(case)
    log(f"kernel {case['name']}: max_abs_err {err:.3e} (tol {tol}), worst rel L2 of a head "
        f"{agree['rel_l2']:.3e} (tol {agree['rel_tol']}), {_body(route)} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{case['name']}: paged kernel disagrees with its plain version")
    ms = graph_ms([run] * 5)
    plain_ms = cuda_ms(plain, iters=3, warmup=1)
    qt, kd, vd, mask = _paged_dense(case)
    lib_ms = graph_ms([lambda: F.scaled_dot_product_attention(
        qt, kd, vd, attn_mask=mask, enable_gqa=(H != kd.shape[1]))] * 5)
    del kd, vd
    # Work these inputs need: the K and V rows (scales included) of each
    # row's tokens read once, q and out once; each query column against its
    # visible keys.
    KH = kp.shape[-3]
    elem = 1 if case["quant"] else 2
    tokens = int(case["np_lengths"].sum())
    nbytes = (tokens * 2 * KH * (D * elem + (4 if case["quant"] else 0))
              + 2 * B * k * H * D * 2 + table.numel() * 4 + B * 4)
    lim = case["np_lengths"][:, None] - window + np.arange(k)[None, :]
    pairs = float(np.clip(lim + 1, 0, None).sum()) * H
    flops = 4.0 * D * pairs
    b_ms, b_by = bound(flops, nbytes)
    log(f"  {case['name']}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
        f"sdpa over pre-gathered dense K/V (gather excluded) {lib_ms:.4f} ms  "
        f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.1f} MB)")
    if case.get("note"):
        note_case(report, case["note"], case["name"], dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, body=_body(route)))
    if case["report"]:
        report.append(dict(name=case["report"], route="cuda",
                           source="vcoder_tpu_torch/csrc/paged_attn.cu",
                           replaces=case["replaces"], launches=0, max_abs_err=err, ms=ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                           library_ms=lib_ms, body=_body(route), status="ok"))


DECODE_LENGTHS = np.linspace(1201, 1233, 8).astype(np.int32)

# Phase 3's paged cases, each (keyword arguments of _paged_case, (report
# row, TPU kernel) or None). Decode and verify windows (C <= 16 columns)
# take the kernel's SPLIT body, chunk windows its TILE body.
PAGED_CASES = [
    (dict(name="paged bf16 decode B=8 w=1 L=32@17 H=KH=32 page 64 len 1201-1233",
          B=8, window=1, H=32, KH=32, lengths=DECODE_LENGTHS),
     ("paged_attn_bf16", "vcoder_tpu/ops/paged_attention.py:297")),
    (dict(name="paged int8 decode B=8 w=1 (same shapes)", B=8, window=1, H=32, KH=32,
          lengths=DECODE_LENGTHS, quant=True, seed=1),
     ("paged_attn_q8", "vcoder_tpu/ops/paged_attention.py:664")),
    (dict(name="paged bf16 verify B=8 w=4", B=8, window=4, H=32, KH=32,
          lengths=DECODE_LENGTHS + 4, seed=2), None),
    (dict(name="paged bf16 chunk 4 rows w=128", B=4, window=128, H=32, KH=32,
          lengths=[1280, 1216, 1152, 1280], seed=3), None),
    (dict(name="paged bf16 GQA 32q/8kv w=4, a length-0 row, a window across a page",
          B=4, window=4, H=32, KH=8, lengths=[0, 66, 130, 1201], seed=4), None),
    (dict(name="paged unstacked pool (K8) B=8 w=1", B=8, window=1, H=32, KH=32,
          lengths=DECODE_LENGTHS, L=1, layer=0, stacked=False, seed=5),
     ("paged_attn_k8", "vcoder_tpu/ops/paged_attention.py:55")),
    (dict(name="paged int8 verify B=8 w=4", B=8, window=4, H=32, KH=32,
          lengths=DECODE_LENGTHS + 4, quant=True, seed=6), None),
    (dict(name="paged int8 GQA 32q/8kv w=4, a length-0 row, a window across a page",
          B=4, window=4, H=32, KH=8, lengths=[0, 66, 130, 1201], quant=True, seed=7), None),
    (dict(name="paged int8 decode B=1 at 1201 tokens", B=1, window=1, H=32, KH=32,
          lengths=[1201], quant=True, seed=8), None),
    (dict(name="paged int8 decode B=2, a row with fewer live pages than the split",
          B=2, window=1, H=32, KH=32, lengths=[1201, 70], quant=True, seed=9), None),
    (dict(name="paged int8 chunk 2 rows w=128", B=2, window=128, H=32, KH=32,
          lengths=[1280, 1200], quant=True, seed=10), None),
    (dict(name="paged int8 chunk 4 rows w=128", B=4, window=128, H=32, KH=32,
          lengths=[1280, 1216, 1152, 1280], quant=True, seed=22), None),
    # TILE body: a 64-key tile of 4 pages of 16 (boxes of 16 rows) and a
    # page of 4 tiles; GQA chunk columns (4 heads a KV head, 4 column tiles
    # a row), a length-0 row and a row of 70 tokens, whose first 58 window
    # columns see no key.
    (dict(name="paged bf16 chunk 4 rows w=128 page 16", B=4, window=128, H=32, KH=32,
          lengths=[1280, 1216, 1152, 1280], page=16, seed=23), None),
    (dict(name="paged bf16 chunk 4 rows w=128 page 256", B=4, window=128, H=32, KH=32,
          lengths=[1280, 1216, 1152, 1280], page=256, seed=24), None),
    (dict(name="paged bf16 GQA 32q/8kv chunk w=128, a length-0 row, a row of 70 tokens",
          B=4, window=128, H=32, KH=8, lengths=[0, 70, 1152, 1280], seed=25), None),
    (dict(name="paged int8 chunk 2 rows w=128 page 16, live page ids past the pool (clipped)",
          B=2, window=128, H=32, KH=32, lengths=[1280, 1200], page=16, quant=True, seed=28,
          bad_ids=True), None),
    # Pages other than 64, on the SPLIT body: a page shorter than a ring
    # tile (each stage part-full), a page of several tiles, and more pages
    # a row than the block reads ids of at its start.
    (dict(name="paged int8 GQA 32q/8kv w=4 page 16, a length-0 row, a window across a page",
          B=4, window=4, H=32, KH=8, lengths=[0, 18, 130, 1201], page=16, quant=True,
          seed=17), None),
    (dict(name="paged int8 decode B=2 page 256 (4 tiles a page), a row of 2 pages",
          B=2, window=1, H=32, KH=32, lengths=[1201, 300], page=256, quant=True, seed=18),
     None),
    (dict(name="paged int8 decode B=1 page 8 at 1201 tokens (151 pages)", B=1, window=1,
          H=32, KH=32, lengths=[1201], page=8, quant=True, seed=19), None),
]


# The 13B engines' shapes (40 layers, H = KH = 40; layer 21 of the stacked
# pool), each (keyword arguments of _paged_case, the kernel's entry it is
# noted on): engine A13's decode on one layer's pool (K8), a verify window
# and a chunk window (K3, SPLIT and TILE bodies), engines E13's and D13's
# int8 decode at B=4 and 16 beside B=8, and an int8 verify window (K4).
DECODE_LENGTHS_16 = np.linspace(1201, 1233, 16).astype(np.int32)
PAGED_CASES_13B = [
    (dict(name="paged 13B unstacked pool (K8) B=8 w=1 H=KH=40 page 64 len 1201-1233", B=8,
          window=1, H=40, KH=40, lengths=DECODE_LENGTHS, L=1, layer=0, stacked=False,
          seed=31), "paged_attn_k8"),
    (dict(name="paged 13B bf16 verify B=8 w=4 L=40@21", B=8, window=4, H=40, KH=40,
          lengths=DECODE_LENGTHS + 4, L=40, layer=21, seed=32), "paged_attn_bf16"),
    (dict(name="paged 13B bf16 chunk 4 rows w=128 L=40@21", B=4, window=128, H=40, KH=40,
          lengths=[1280, 1216, 1152, 1280], L=40, layer=21, seed=33), "paged_attn_bf16"),
    (dict(name="paged 13B int8 decode B=4 w=1 L=40@21", B=4, window=1, H=40, KH=40,
          lengths=DECODE_LENGTHS[::2], L=40, layer=21, quant=True, seed=34), "paged_attn_q8"),
    (dict(name="paged 13B int8 decode B=8 w=1 L=40@21", B=8, window=1, H=40, KH=40,
          lengths=DECODE_LENGTHS, L=40, layer=21, quant=True, seed=35), "paged_attn_q8"),
    (dict(name="paged 13B int8 decode B=16 w=1 L=40@21", B=16, window=1, H=40, KH=40,
          lengths=DECODE_LENGTHS_16, L=40, layer=21, quant=True, seed=36), "paged_attn_q8"),
    (dict(name="paged 13B int8 verify B=8 w=4 L=40@21", B=8, window=4, H=40, KH=40,
          lengths=DECODE_LENGTHS + 4, L=40, layer=21, quant=True, seed=37), "paged_attn_q8"),
]


def phase_paged_kernels(report: list) -> None:
    """The paged kernel against its plain version at the engine's shapes."""
    import torch

    from vcoder_tpu_torch.ops import paged_attention as pa

    for kw, rep in PAGED_CASES:
        case = _paged_case(**kw)
        if rep:
            case["report"], case["replaces"] = rep
        check_paged(case, report)
        del case
        torch.cuda.empty_cache()
    pa.reset_launches()  # comparison launches do not count


def _fused_case(name, *, B, window, H, KH, lengths, active=None, page=64, quant=False,
                seed=0, L=32, layer=17):
    """Inputs for one fused append + attend comparison: the pools, table and
    query of :func:`_paged_case` (layer 17 of 32, pages of ``page``; ``lengths``
    include the window for active rows only), plus the window's new K/V
    (int8 values and f32 scales for int8 pools), ``positions = lengths -
    window * active`` and the active mask."""
    import torch

    case = _paged_case(name, B=B, window=window, H=H, KH=KH, lengths=lengths, L=L, layer=layer,
                       page=page, quant=quant, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 50)
    act = np.ones(B, bool) if active is None else np.asarray(active)
    shape = (B, window, KH, 128)
    if quant:
        nk, nv = (torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
                  for _ in range(2))
        nks, nvs = (torch.rand(shape[:-1], generator=gen, device="cuda") * (2.0 / 127) + 0.5 / 127
                    for _ in range(2))
    else:
        nk, nv = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                  for _ in range(2))
        nks = nvs = None
    pos = case["np_lengths"] - window * act.astype(np.int32)
    case.update(nk=nk, nv=nv, nks=nks, nvs=nvs, np_active=act, np_pos=pos,
                active=torch.from_numpy(act).cuda(), positions=torch.from_numpy(pos).cuda())
    return case


def _pool_list(case, layer_slice=None):
    pools = [case[x] for x in ("kp", "vp", "ks", "vs") if case[x] is not None]
    return pools if layer_slice is None else [p[layer_slice] for p in pools]


def fused_call(case: dict):
    """``fused(pools, layer)``: K7 on ``case`` over the given pools."""
    from vcoder_tpu_torch.ops import paged_attention as pa

    q, table, lengths, window = (case[x] for x in ("q", "table", "lengths", "window"))
    nk, nv, nks, nvs, pos, act = (case[x] for x in ("nk", "nv", "nks", "nvs", "positions",
                                                    "active"))

    def fused(pools, l):
        kw = dict(window=window)
        if case["quant"]:
            kw.update(k_scale=pools[2], v_scale=pools[3], new_ks=nks, new_vs=nvs)
        return pa.carry_paged_attention_fused(q, nk, nv, pools[0], pools[1], table, lengths, pos,
                                              act, l, **kw)

    return fused


def fused_agreement(case: dict) -> dict:
    """K7 against its plain version on ``case``: the active rows' outputs
    within the gate, every pool page but the scratch page byte-equal to the
    plain version's, and the scratch page holding the inactive rows' writes
    (or unchanged with none)."""
    import torch

    from vcoder_tpu_torch.ops import paged_attention as pa

    q, table, lengths, layer, window = (case[x] for x in ("q", "table", "lengths", "layer",
                                                          "window"))
    nk, nv, nks, nvs, pos, act = (case[x] for x in ("nk", "nv", "nks", "nvs", "positions",
                                                    "active"))
    quant = case["quant"]
    n_pages = case["kp"].shape[1]
    page = case["page"]
    fused = fused_call(case)
    before = [p.clone() for p in _pool_list(case, slice(layer, layer + 1))]
    plain_pools = [p.clone() for p in before]
    out = fused(_pool_list(case), layer)
    kw = dict(window=window)
    if quant:
        kw.update(k_scale=plain_pools[2], v_scale=plain_pools[3], new_ks=nks, new_vs=nvs)
    ref = pa.carry_paged_attention_fused_ref(q, nk, nv, plain_pools[0], plain_pools[1], table,
                                             lengths, pos, act, 0, **kw)
    torch.cuda.synchronize()
    a = case["np_active"]
    rows = torch.from_numpy(a).cuda()
    err, rel = attn_gaps(out[rows], ref[rows])
    got = _pool_list(case, slice(layer, layer + 1))
    pages_equal = all(torch.equal(g[:, :-1], p[:, :-1]) for g, p in zip(got, plain_pools))
    scratch_ok = True
    srcs = [nk, nv] + ([nks, nvs] if quant else [])
    for b in np.nonzero(~a)[0]:
        for t in range(window):
            off = (int(case["np_pos"][b]) + t) % page
            for g, src in zip(got, srcs):
                scratch_ok &= torch.equal(g[0, n_pages - 1, :, off], src[b, t])
    if a.all():
        scratch_ok = all(torch.equal(g[:, -1], p[:, -1]) for g, p in zip(got, before))
    ok = bool(err <= PAGED_MAX_ABS and rel <= PAGED_REL_L2 and pages_equal and scratch_ok
              and torch.isfinite(out.float()[rows]).all().item())
    return dict(ok=ok, max_abs=err, tol=PAGED_MAX_ABS, rel_l2=rel, rel_tol=PAGED_REL_L2,
                pages_equal=bool(pages_equal), scratch_ok=bool(scratch_ok))


def check_fused(case: dict, report: list) -> None:
    """K7 against its plain version on one case (:func:`fused_agreement`);
    timed beside the port's unfused route (the append writers, then K8 / K3 /
    K4) and SDPA over pre-gathered K/V."""
    import torch
    import torch.nn.functional as F

    from vcoder_tpu_torch.ops import paged_attention as pa

    q, table, lengths, layer, window = (case[x] for x in ("q", "table", "lengths", "layer",
                                                          "window"))
    nk, nv, nks, nvs, pos, act = (case[x] for x in ("nk", "nv", "nks", "nvs", "positions",
                                                    "active"))
    quant = case["quant"]
    B, k, H, D = q.shape
    KH, page = case["kp"].shape[2], case["page"]
    fused = fused_call(case)
    agree = fused_agreement(case)
    err, tol = agree["max_abs"], agree["tol"]
    route = paged_split(case, fused=True)
    log(f"kernel {case['name']}: max_abs_err {err:.3e} on active rows (tol {tol}), worst rel "
        f"L2 of a head {agree['rel_l2']:.3e} (tol {agree['rel_tol']}), pool pages "
        f"byte-equal but the scratch page {agree['pages_equal']}, scratch page holds the "
        f"inactive rows' writes {agree['scratch_ok']}, {_body(route)} -> "
        f"{'ok' if agree['ok'] else 'FAIL'}")
    if not agree["ok"]:
        raise SystemExit(f"{case['name']}: fused kernel disagrees with its plain version")
    a = case["np_active"]
    kw = dict(window=window)
    if quant:
        kw.update(new_ks=nks, new_vs=nvs)

    pools = _pool_list(case)
    ms = graph_ms([lambda: fused(pools, layer)] * 5)
    plain_pools = [p.clone() for p in _pool_list(case, slice(layer, layer + 1))]
    plain_ms = cuda_ms(lambda: pa.carry_paged_attention_fused_ref(
        q, nk, nv, plain_pools[0], plain_pools[1], table, lengths, pos, act, 0,
        **({**kw, "k_scale": plain_pools[2], "v_scale": plain_pools[3]} if quant else kw)),
        iters=3, warmup=1)
    del plain_pools
    pos2d = pos.long()[:, None] + torch.arange(window, device="cuda")[None, :]

    def unfused():
        pa.append_tokens_layer(pools[0], layer, nk, pos2d, table, act)
        pa.append_tokens_layer(pools[1], layer, nv, pos2d, table, act)
        if quant:
            pa.append_token_scales_layer(pools[2], layer, nks, pos2d, table, act)
            pa.append_token_scales_layer(pools[3], layer, nvs, pos2d, table, act)
            return pa.carry_paged_attention_multi_q8(q, *pools, table, lengths, layer,
                                                     window=window)
        if window == 1:
            return pa.carry_paged_attention(q[:, 0], pools[0], pools[1], table, lengths, layer)
        return pa.carry_paged_attention_multi(q, pools[0], pools[1], table, lengths, layer,
                                              window=window)

    unfused_ms = graph_ms([unfused] * 5)
    qt, kd, vd, mask = _paged_dense(case)
    lib_ms = graph_ms([lambda: F.scaled_dot_product_attention(
        qt, kd, vd, attn_mask=mask, enable_gqa=(H != KH))] * 5)
    del kd, vd
    # Work these inputs need: the K/V (and scales) of each row's old tokens
    # read once, the window's K/V read from the operands and written to the
    # pool once, q and out once; each query column against its old tokens
    # and, for an active row, the window causally.
    elem = 1 if quant else 2
    old = case["np_lengths"] - window * a.astype(np.int64)
    row_bytes = KH * (D * elem + (4 if quant else 0))
    nbytes = (2 * int(old.sum()) * row_bytes + 2 * 2 * int(a.sum()) * window * row_bytes
              + 2 * B * k * H * D * 2 + table.numel() * 4 + 3 * B * 4)
    pairs = float(H * (old * window + a * window * (window + 1) // 2).sum())
    b_ms, b_by = bound(4.0 * D * pairs, nbytes)
    log(f"  {case['name']}: kernel {ms:.4f} ms  unfused route (append writers + paged kernel) "
        f"{unfused_ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa over pre-gathered dense K/V "
        f"{lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB)")
    if case.get("note"):
        note_case(report, "paged_attn_fused", case["name"], dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, unfused_ms=unfused_ms, body=_body(route)))
    if case["report"]:
        report.append(dict(name="paged_attn_fused", route="cuda",
                           source="vcoder_tpu_torch/csrc/paged_attn.cu",
                           replaces="vcoder_tpu/ops/paged_attention.py:1263", launches=0,
                           max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms, unfused_ms=unfused_ms,
                           body=_body(route), status="ok"))


# Phase 9's fused cases (keyword arguments of _fused_case); the first is
# the report row. The GQA windows of 8 take the kernel's TILE body, the
# others its SPLIT body.
FUSED_CASES = [
    dict(name="fused bf16 decode B=8 w=1 L=32@17 H=KH=32 page 64 len 1201-1233", B=8,
         window=1, H=32, KH=32, lengths=DECODE_LENGTHS, seed=11),
    dict(name="fused bf16 verify B=8 w=4", B=8, window=4, H=32, KH=32,
         lengths=DECODE_LENGTHS + 3, seed=12),
    dict(name="fused int8 decode B=8 w=1", B=8, window=1, H=32, KH=32,
         lengths=DECODE_LENGTHS, quant=True, seed=13),
    dict(name="fused int8 verify B=8 w=4", B=8, window=4, H=32, KH=32,
         lengths=DECODE_LENGTHS + 3, quant=True, seed=14),
    dict(name="fused bf16 GQA 32q/8kv w=4, an inactive row, a window across a page", B=4,
         window=4, H=32, KH=8, lengths=[66, 130, 1201, 37],
         active=[True, True, True, False], seed=15),
    dict(name="fused int8 GQA 32q/8kv w=4, an inactive row, a window across a page", B=4,
         window=4, H=32, KH=8, lengths=[66, 130, 1201, 37],
         active=[True, True, True, False], quant=True, seed=16),
    dict(name="fused int8 GQA 32q/8kv w=4 page 16, an inactive row, a window across a page",
         B=4, window=4, H=32, KH=8, lengths=[18, 130, 1201, 37],
         active=[True, True, True, False], page=16, quant=True, seed=20),
    dict(name="fused bf16 verify B=2 w=4 page 128 (4 tiles a page)", B=2, window=4, H=32,
         KH=32, lengths=[1204, 300], page=128, seed=21),
    # C = 4 x 8 = 32 columns: the TILE body, the window a tile of its own.
    dict(name="fused bf16 GQA 32q/8kv w=8 (C=32), an inactive row, a window across a page",
         B=4, window=8, H=32, KH=8, lengths=[70, 134, 1205, 37],
         active=[True, True, True, False], seed=26),
    dict(name="fused int8 GQA 32q/8kv w=8 (C=32), an inactive row, a window across a page",
         B=4, window=8, H=32, KH=8, lengths=[70, 134, 1205, 37],
         active=[True, True, True, False], quant=True, seed=27),
]


# K7 at the 13B decode step (noted on K7's entry): bf16 and int8 pools.
FUSED_CASES_13B = [
    dict(name="fused 13B bf16 decode B=8 w=1 L=40@21 H=KH=40 page 64 len 1201-1233", B=8,
         window=1, H=40, KH=40, lengths=DECODE_LENGTHS, L=40, layer=21, seed=38),
    dict(name="fused 13B int8 decode B=8 w=1 L=40@21 H=KH=40", B=8, window=1, H=40, KH=40,
         lengths=DECODE_LENGTHS, L=40, layer=21, quant=True, seed=39),
]


def phase_fused_kernels(report: list) -> None:
    """K7 against its plain version at the engine's shapes: bf16 and int8
    pools at windows 1 and 4 (B=8, H=KH=32, lengths 1201-1233 with the
    window), and a GQA case (32 query heads over 8 KV heads) with an inactive
    row and a window across a page boundary."""
    import torch

    from vcoder_tpu_torch.ops import paged_attention as pa

    for i, kw in enumerate(FUSED_CASES):
        case = _fused_case(**kw)
        case["report"] = i == 0
        check_fused(case, report)
        del case
        torch.cuda.empty_cache()
    pa.reset_launches()  # comparison launches do not count


def check_vit_mlp(report: list) -> None:
    """K9 against its plain version at the tower's shape (B=3, T=577,
    Dm=1024, I=4096, bf16, non-zero LN parameters and biases)."""
    import torch
    import torch.nn.functional as F

    from vcoder_tpu_torch.ops import vit_attention as va

    B, T, Dm, I = 3, 577, 1024, 4096
    eps = 1e-5
    rng = np.random.RandomState(4)

    def randn(*shape, s=1.0, c=0.0):
        return torch.from_numpy((c + rng.randn(*shape) * s).astype(np.float32)).to(
            "cuda", torch.bfloat16)

    x = randn(B, T, Dm)
    ln_s, ln_b = randn(Dm, s=0.1, c=1.0), randn(Dm, s=0.1)
    fc1, b1 = randn(Dm, I, s=0.03), randn(I, s=0.1)
    fc2, b2 = randn(I, Dm, s=0.03), randn(Dm, s=0.1)
    args = (x, ln_s, ln_b, fc1, b1, fc2, b2)
    y = va.fused_block_mlp(*args, eps=eps)
    ref = va.fused_block_mlp_ref(*args, eps=eps)
    torch.cuda.synchronize()
    # Both round the normalized row, the GELU output and the result to bf16
    # at the same places; f32 sums in another order may move an
    # intermediate across a rounding boundary.
    agree = check_tower_gates("vit_mlp", y, ref, 2e-2 * max(1.0, ref.float().abs().max().item()))
    # The f32 route of the LN kernel and of the epilogues' bias loads: the LN
    # parameters and biases drawn in f32, off the bf16 grid.
    def randn32(n, s, c=0.0):
        return torch.from_numpy((c + rng.randn(n) * s).astype(np.float32)).to("cuda")

    args32 = (x, randn32(Dm, 0.1, 1.0), randn32(Dm, 0.1), fc1, randn32(I, 0.1), fc2,
              randn32(Dm, 0.1))
    ref32 = va.fused_block_mlp_ref(*args32, eps=eps)
    check_tower_gates("vit_mlp, f32 LN parameters and biases", va.fused_block_mlp(*args32, eps=eps),
                      ref32, 2e-2 * max(1.0, ref32.float().abs().max().item()))
    ms = graph_ms([lambda: va.fused_block_mlp(*args, eps=eps)] * 5)
    plain_ms = cuda_ms(lambda: va.fused_block_mlp_ref(*args, eps=eps), iters=3, warmup=1)
    M = B * T

    def library():
        h = F.layer_norm(x, (Dm,), ln_s, ln_b, eps).view(M, Dm)
        t = torch.addmm(b1, h, fc1)
        t = t * torch.sigmoid(1.702 * t)
        return torch.addmm(b2, t, fc2).view(B, T, Dm) + x

    lib_ms = graph_ms([library] * 5)
    # The three launches apart (the bf16 vectors as the wrapper passes them).
    x2 = x.view(M, Dm)
    h = torch.empty((M, Dm), dtype=torch.bfloat16, device="cuda")
    g = torch.empty((M, I), dtype=torch.bfloat16, device="cuda")
    out = torch.empty((M, Dm), dtype=torch.bfloat16, device="cuda")
    va.launch_layer_norm(x2, ln_s, ln_b, h, eps)
    va.launch_mlp_gemm(h, fc1, b1, None, g, gelu=True)
    ln_ms = graph_ms([lambda: va.launch_layer_norm(x2, ln_s, ln_b, h, eps)] * 5)
    fc1_ms = graph_ms([lambda: va.launch_mlp_gemm(h, fc1, b1, None, g, gelu=True)] * 5)
    fc2_ms = graph_ms([lambda: va.launch_mlp_gemm(g, fc2, b2, x2, out, gelu=False)] * 5)
    lib_fc1_ms = graph_ms([lambda: torch.addmm(b1, h, fc1)] * 5)
    lib_fc2_ms = graph_ms([lambda: torch.addmm(b2, g, fc2)] * 5)
    va.launches_mlp = 0  # comparison launches do not count
    f_gemm = 2.0 * M * Dm * I
    flops = 2 * f_gemm
    nbytes = 2 * M * Dm * 2 + 2 * Dm * I * 2 + (3 * Dm + I) * 2
    b_ms, b_by = bound(flops, nbytes)
    ln_bound, _ = bound(0, 2 * M * Dm * 2 + 2 * Dm * 4)
    log(f"  vit_mlp: kernels {_tflops(flops, ms)}  plain {plain_ms:.4f} ms"
        f"  layer_norm + addmm + quick-GELU + addmm + residual {lib_ms:.4f} ms  bound "
        f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
    log(f"    LN2 {ln_ms:.4f} ms (byte bound {ln_bound:.4f} ms); fc1 GEMM {_tflops(f_gemm, fc1_ms)}, "
        f"cuBLAS addmm {lib_fc1_ms:.4f} ms; fc2 GEMM {_tflops(f_gemm, fc2_ms)}, cuBLAS addmm "
        f"{lib_fc2_ms:.4f} ms")
    report.append(dict(name="vit_mlp", route="cuda", source="vcoder_tpu_torch/csrc/vit_mlp.cu",
                       replaces="vcoder_tpu/ops/vit_attention.py:154", launches=0,
                       max_abs_err=agree["max_abs"], rel_l2=agree["rel_l2"], ms=ms,
                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                       gemm_ms=fc1_ms + fc2_ms, ln_ms=ln_ms, status="ok"))


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


# K5's cases. Timed, at B=1 (a B=1 decode step) and B=8 (engine D's step):
# the 7B decoder's q/k/v/o, gate/up and down weights and lm_head, each
# (label, K, N). Untimed, (B, K, N, x's row stride): B past one group of 8
# rows and not a multiple of 8, N not a multiple of 16 (the weight read
# byte by byte), K = 1040, x with a row stride > K (odd in one case: read
# element by element); B = 13 on the vector path (N = 1200, whose last
# column tile is ragged); and K = 1000, whose last k-step is partial.
INT4_SHAPES = (("q/k/v/o", 4096, 4096), ("gate/up", 4096, 11008), ("down", 11008, 4096),
               ("lm_head", 4096, 32000))
INT4_MAIN = (1, 4096, 11008)
# The local shards a rank of a model split of 2 gives K5 at decode (phase
# 15): down_proj's input rows halved, gate/up's output columns halved.
INT4_LOCAL = (("local down", 5504, 4096), ("local gate/up", 4096, 5504))
INT4_RAGGED = ((3, 1040, 1000, 1064), (13, 1040, 1000, 1043), (40, 1040, 1000, 1056),
               (13, 1040, 1200, 1048), (5, 1000, 1200, 1000))
# The 13B decoder's products (hidden 5120, intermediate 13824), timed at B=1
# (the B=1 decode), 8 and 16 (engine D13's capacity batch); noted on K5's
# entry.
INT4_SHAPES_13B = (("13B q/k/v/o", 5120, 5120), ("13B gate/up", 5120, 13824),
                   ("13B down", 13824, 5120), ("13B lm_head", 5120, 32000))


def int4_operands(B: int, K: int, N: int, sx: int = 0):
    """Seeded ``x [B, K]`` (bf16, row stride ``sx`` or K), packed ``qp [K/2,
    N]`` and a per-column f32 scale ``[1, N]`` on the card. x and qp are
    views into larger random buffers, so whatever a kernel reads past K, B
    or N is random, not zero."""
    import torch

    sx = sx or K
    rng = np.random.RandomState(B + K + N + sx)
    gen = torch.Generator(device="cuda").manual_seed(K + N)
    buf = torch.randint(-128, 128, (K // 2 * N + 128 * N + 256,), generator=gen, device="cuda",
                        dtype=torch.int8)
    qp = buf[:K // 2 * N].view(K // 2, N)
    xs = torch.from_numpy(rng.randn(B + 1, sx).astype(np.float32)).to("cuda", torch.bfloat16)
    x = xs[:B, :K]
    scale = torch.from_numpy((rng.rand(1, N) * 1e-3 + 1e-3).astype(np.float32)).cuda()
    return x, qp, scale


def int4_agreement(x, qp, scale) -> dict:
    """K5 on one case: the product against its plain version (max-abs
    error and its tolerance), the scaled form against the kernel's own
    product times ``scale.to(x.dtype)`` (bit-equal), and a second launch
    against the first (bit-identical), and whether all three hold."""
    import torch

    from vcoder_tpu_torch.ops import int4_matmul as i4

    y = i4.launch_int4_matmul(x, qp)
    y2 = i4.launch_int4_matmul(x, qp)
    ys = i4.launch_int4_matmul(x, qp, scale)
    torch.cuda.synchronize()
    ref = i4.int4_matmul_ref(x, qp)
    err = (y.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    # f32 sums in another order, then one bf16 rounding each: two bf16 ulps
    # at the largest output.
    tol = 2.0 ** -7 * max(1.0, top)
    scaled_equal = bool(torch.equal(ys, y * scale.to(x.dtype)))
    repeat_equal = bool(torch.equal(y, y2))
    finite = bool(torch.isfinite(y.float()).all() and torch.isfinite(ys.float()).all())
    return dict(max_abs=err, tol=tol, max_ref=top, scaled_bit_equal=scaled_equal,
                repeat_bit_equal=repeat_equal,
                ok=err <= tol and finite and scaled_equal and repeat_equal)


def check_int4(label: str, B: int, K: int, N: int, sx: int = 0, timed: bool = True,
               report=None) -> dict:
    """K5 against its plain version at one case (``int4_agreement``); when
    ``timed``, both forms timed over weight copies that keep L2 cold (a
    decode step reads each weight once, from HBM), beside the plain version,
    a bf16 matmul over the dequantized weight (the library column) and the
    byte bound. Returns the case's numbers."""
    import torch

    from vcoder_tpu_torch.ops import int4_matmul as i4

    x, qp, scale = int4_operands(B, K, N, sx)
    agree = int4_agreement(x, qp, scale)
    name = f"int4_matmul {label} B={B} K={K} N={N}" + (f" stride {sx}" if sx else "")
    log(f"kernel {name}: max_abs_err {agree['max_abs']:.3e} (tol {agree['tol']:.3e}, max|ref| "
        f"{agree['max_ref']:.1f}), scaled form bit-equal to product x scale "
        f"{agree['scaled_bit_equal']}, two launches bit-identical {agree['repeat_bit_equal']} "
        f"-> {'ok' if agree['ok'] else 'FAIL'}")
    if not agree["ok"]:
        raise SystemExit(f"{name}: kernel disagrees with its plain version")
    row = dict(label=label, B=B, K=K, N=N, max_abs_err=agree["max_abs"])
    if not timed:
        return row
    w_bytes = K // 2 * N
    copies = _copies(qp, w_bytes)
    ms = graph_ms([lambda q=q: i4.launch_int4_matmul(x, q) for q in copies])
    ms_scaled = graph_ms([lambda q=q: i4.launch_int4_matmul(x, q, scale) for q in copies])
    plain_ms = cuda_ms(lambda: i4.int4_matmul_ref(x, qp), iters=3, warmup=1)
    wb = torch.stack(i4.nibbles(qp), dim=1).reshape(K, N).to(torch.bfloat16)
    lib_ms = graph_ms([lambda w=w: torch.matmul(x, w) for w in _copies(wb, 2 * K * N)])
    del wb, copies
    flops = 2.0 * B * K * N
    nbytes = w_bytes + B * K * 2 + B * N * 2
    b_ms, b_by = bound(flops, nbytes)
    cluster = i4._CLUSTER.get((torch.cuda.current_device(), K // 2, N, B))
    log(f"  {name} (clusters of {cluster}): kernel {ms:.4f} ms ({b_ms / ms:.0%} of bound), "
        f"with the scale {ms_scaled:.4f} ms  plain {plain_ms:.4f} ms  bf16 matmul over the "
        f"dequantized weight {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.1f} MB; CUDA-graph "
        f"replay over weight copies >120 MB, L2 cold)")
    torch.cuda.empty_cache()
    row.update(ms=ms, ms_scaled=ms_scaled, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by, share=b_ms / ms, cluster=cluster)
    if report is not None:
        report.append(dict(name="int4_matmul", route="cuda",
                           source="vcoder_tpu_torch/csrc/int4_matmul.cu",
                           replaces="vcoder_tpu/ops/int4_matmul.py:47",
                           launches=0, max_abs_err=agree["max_abs"], ms=ms, plain_ms=plain_ms,
                           bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, ms_scaled=ms_scaled,
                           status="ok"))
    return row


def int4_cases(report=None) -> list:
    """Every K5 case: the eight timed ones (``INT4_SHAPES`` at B=1 and B=8),
    the local shards of a model split of 2 at B=8 (``INT4_LOCAL``), then
    the ragged ones (``INT4_RAGGED``); the main shape (``INT4_MAIN``) goes
    to ``report``."""
    rows = [check_int4(label, B, K, N, report=report if (B, K, N) == INT4_MAIN else None)
            for B in (1, 8) for label, K, N in INT4_SHAPES]
    rows += [check_int4(label, 8, K, N) for label, K, N in INT4_LOCAL]
    rows += [check_int4("ragged", B, K, N, sx, timed=False) for B, K, N, sx in INT4_RAGGED]
    return rows


# K10's cases: the six W8A8 products of a quantized prefill (the 7B
# decoder's q/k/v/o, gate/up and down at 1280 rows; the CLIP tower's
# q/k/v/out, fc1 and fc2 at 3 x 577 rows), the local shards of a model
# split of 2 at one prefill's rows (down's input rows and gate/up's output
# columns halved), then a ragged case that no tile divides (M, K and N
# past a tile edge).
INT8_CASES = (
    ("decoder q/k/v/o", 1280, 4096, 4096),
    ("decoder gate/up", 1280, 4096, 11008),
    ("decoder down", 1280, 11008, 4096),
    ("tower q/k/v/out", 1731, 1024, 1024),
    ("tower fc1", 1731, 1024, 4096),
    ("tower fc2", 1731, 4096, 1024),
    ("local down", 1232, 5504, 4096),
    ("local gate/up", 1232, 4096, 5504),
    ("ragged", 333, 1040, 1200),
)
INT8_MAIN = (1280, 4096, 11008)
# The 13B decoder's W8A8 products at one DS prefill's rows (1232) and at
# 1792 rows, each noted on K10's entries in both forms.
INT8_CASES_13B = tuple((f"13B {label}", M, K, N) for M in (1232, 1792)
                       for label, K, N in (("q/k/v/o", 5120, 5120), ("gate/up", 5120, 13824),
                                           ("down", 13824, 5120)))


def int8_operands(M: int, K: int, N: int):
    """Seeded int8 ``a [M, K]``, ``b [K, N]`` and f32 scales on the card. The
    operands are the first elements of larger random buffers, so whatever a
    kernel reads past K, M or N is random, not zero."""
    import torch

    rng = np.random.RandomState(M + K + N)
    gen = torch.Generator(device="cuda").manual_seed(M + K)
    tail = 128 * max(K, N) + 256

    def block(rows, cols):
        buf = torch.randint(-127, 128, (rows * cols + tail,), generator=gen, device="cuda",
                            dtype=torch.int8)
        return buf[:rows * cols].view(rows, cols)

    a, b = block(M, K), block(K, N)
    sa = torch.from_numpy((rng.rand(M, 1) * 0.02 + 1e-3).astype(np.float32)).cuda()
    sb = torch.from_numpy((rng.rand(1, N) * 0.002 + 1e-4).astype(np.float32)).cuda()
    return a, b, sa, sb


def int8_agreement(a, b, sa, sb) -> dict:
    """K10 in both forms on one case against the plain versions: the s32
    form's max-abs error (exact: 0) and the scaled form's max-abs and
    largest relative error (one bf16 rounding: 2**-8), and whether both
    hold."""
    import torch

    from vcoder_tpu_torch.ops import int8_matmul as i8

    c = i8.launch_int8_mm(a, b)
    y = i8.launch_int8_mm_scaled(a, b, sa, sb)
    torch.cuda.synchronize()
    err_s32 = (c.long() - i8.int8_mm_ref(a, b).long()).abs().max().item()
    y_ref = i8.int8_mm_scaled_ref(a, b, sa, sb)
    diff = (y.float() - y_ref.float()).abs()
    # The s32 product is exact; the scaled form rounds the same f32 products
    # once to bf16, so it may differ from the plain version by at most one
    # bf16 rounding (2**-8 of the value).
    rel = (diff / y_ref.float().abs().clamp_min(1e-30)).max().item()
    return dict(err_s32=err_s32, err_scaled=diff.max().item(), rel_scaled=rel,
                bit_equal=bool(torch.equal(y, y_ref)),
                ok=err_s32 == 0 and rel <= 2.0 ** -8 and bool(torch.isfinite(y.float()).all()))


def check_int8(label: str, M: int, K: int, N: int, report, note: bool = False) -> None:
    """K10 in both forms against their plain versions at one case, timed
    beside ``torch._int_mm`` on the N-major weight (the library column) and
    on a K-major copy of it made outside the timed call (what cuBLASLt does
    when the layout suits it). Into ``report`` (when given) as each form's
    entry, or with ``note`` noted on each form's entry there."""
    import torch

    from vcoder_tpu_torch.ops import int8_matmul as i8

    a, b, sa, sb = int8_operands(M, K, N)
    agree = int8_agreement(a, b, sa, sb)
    name = f"{label} M={M} K={K} N={N}"
    log(f"kernel int8_mm {name}: s32 max_abs_err {agree['err_s32']} (tol 0); int8_mm_scaled "
        f"bf16 max_abs_err {agree['err_scaled']:.3e}, max relative {agree['rel_scaled']:.3e} "
        f"(tol 2^-8), bit-equal {agree['bit_equal']} -> {'ok' if agree['ok'] else 'FAIL'}")
    if not agree["ok"]:
        raise SystemExit(f"int8_mm {name}: kernel disagrees with its plain version")
    ops = 2.0 * M * K * N
    bt = b.t().contiguous()
    for form, run, plain, out_bytes in (
        ("int8_mm", lambda: i8.launch_int8_mm(a, b), lambda: i8.int8_mm_ref(a, b), 4),
        ("int8_mm_scaled", lambda: i8.launch_int8_mm_scaled(a, b, sa, sb),
         lambda: i8.int8_mm_scaled_ref(a, b, sa, sb), 2),
    ):
        ms = graph_ms([run] * 5)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        if form == "int8_mm":
            lib_ms = graph_ms([lambda: torch._int_mm(a, b)] * 5)
            kmaj_ms = graph_ms([lambda: torch._int_mm(a, bt.t())] * 5)
        else:
            lib_ms = graph_ms(
                [lambda: (torch._int_mm(a, b).float() * sa * sb).to(torch.bfloat16)] * 5)
            kmaj_ms = graph_ms(
                [lambda: (torch._int_mm(a, bt.t()).float() * sa * sb).to(torch.bfloat16)] * 5)
        nbytes = M * K + K * N + M * N * out_bytes + (4 * (M + N) if out_bytes == 2 else 0)
        b_ms, b_by = bound(ops, nbytes, PEAK_INT8_OPS)
        epi = " + epilogue" if out_bytes == 2 else ""
        log(f"  {form} {name}: kernel {ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s)  plain "
            f"{plain_ms:.4f} ms  torch._int_mm{epi} {lib_ms:.4f} ms  torch._int_mm on a "
            f"K-major copy{epi} {kmaj_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}; "
            f"{ops / 1e9:.1f} GOP at 1979 TOP/s, {nbytes / 1e6:.1f} MB)")
        if report is not None and note:
            note_case(report, form, name, dict(
                max_abs_err=float(agree["err_s32"] if form == "int8_mm" else agree["err_scaled"]),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                library_kmajor_ms=kmaj_ms))
        elif report is not None:
            report.append(dict(
                name=form, route="cuda", source="vcoder_tpu_torch/csrc/int8_mm.cu",
                replaces=("scripts/bench_int8_matmul.py:76" if form == "int8_mm"
                          else "scripts/bench_int8_matmul.py:92"),
                launches=0,
                max_abs_err=float(agree["err_s32"] if form == "int8_mm" else agree["err_scaled"]),
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                status="ok"))
    del a, b, bt
    torch.cuda.empty_cache()


def phase_quant_kernels(report: list) -> None:
    """K5 and K10 against their plain versions at the quantized path's
    shapes: int4 decode at B=1 and B=8 over the 7B q/k/v/o, gate/up, down
    and lm_head weights, two local shards and five ragged cases
    (``int4_cases``); the W8A8 product at its six prefill shapes, two local
    shards and a ragged case (``INT8_CASES``)."""
    import torch

    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8

    int4_cases(report)
    for label, M, K, N in INT8_CASES:
        check_int8(label, M, K, N, report if (M, K, N) == INT8_MAIN else None)
    i4.launches = 0  # comparison launches do not count
    i8.reset_launches()
    # The yardsticks ran cuBLAS on one side stream per CUDA graph, each with
    # a workspace that stays allocated: free them, so the later phases'
    # memory readings do not carry them.
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


def phase_kernels_13b(report: list) -> None:
    """Phase 3's serving kernels at the 13B decoder's shapes (40 heads of
    128, hidden 5120, intermediate 13824), each gated as its table's cases
    and noted on its kernel's entry of ``report`` (:func:`note_case`): K1's
    prefill at H=KH=40, the paged cases of ``PAGED_CASES_13B`` and
    ``FUSED_CASES_13B``, K5 at B=1, 8 and 16 over ``INT4_SHAPES_13B`` and
    K10 in both forms over ``INT8_CASES_13B``. The comparison launches do
    not count."""
    import torch

    case = _flash_case("flash_fwd 13B causal T=1280 (1201 valid) S=1312 H=KH=40 D=128",
                       1, 1280, 1312, 40, 40, 128, causal=True, n_valid=1201, seed=13)
    case["note"] = "flash_fwd"
    check_flash(case, report)
    for kw, note in PAGED_CASES_13B:
        case = _paged_case(**kw)
        case["note"] = note
        check_paged(case, report)
        del case
        torch.cuda.empty_cache()
    for kw in FUSED_CASES_13B:
        case = _fused_case(**kw)
        case["report"], case["note"] = False, True
        check_fused(case, report)
        del case
        torch.cuda.empty_cache()
    for B in (1, 8, 16):
        for label, K, N in INT4_SHAPES_13B:
            row = check_int4(label, B, K, N)
            note_case(report, "int4_matmul", f"{label} B={B} K={K} N={N}",
                      {k: row[k] for k in ("max_abs_err", "ms", "ms_scaled", "plain_ms",
                                           "bound_ms", "bound_by", "library_ms", "cluster")})
    for label, M, K, N in INT8_CASES_13B:
        check_int8(label, M, K, N, report, note=True)
    _reset_counters()
    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None:
        clear()


def phase_flash_kernels(report: list) -> None:
    """K1 in five of its six cases (the training shape is
    :func:`check_flash_training`'s)."""
    # The decoder prefill: T=1280 rows, 1201 valid, a cache of S=1280+32.
    main = _flash_case("flash_fwd causal T=1280 (1201 valid) S=1312 H=KH=32 D=128",
                       1, 1280, 1312, 32, 32, 128, causal=True, n_valid=1201)
    main["report"] = "flash_fwd"
    check_flash(main, report)
    check_flash(_flash_case("flash_fwd GQA 8q/2kv, kv_mask holes, a fully-masked row, S>T",
                            2, 200, 333, 8, 2, 128, causal=True, holes=True,
                            dead_row=True, seed=2), report)
    check_flash(_flash_case("flash_fwd d64 bidirectional B=3 T=S=577 H=16",
                            3, 577, 577, 16, 16, 64, causal=False, seed=3), report)
    for case in _flash_edge_cases():
        check_flash(case, report)


def phase_kernels(report: list) -> None:
    phase_flash_kernels(report)
    check_tower_gemms()
    check_vit_block(report)
    check_vit_mlp(report)


def _flash_edge_layouts():
    """(label, H, KH, (positions [B,T], key mask [B,S])) of two causal
    layouts that reach the kernels' per-tile mask decisions, their causal
    bounds and skips, and the ragged TMA edges: positions that are not
    monotone (row 0 left-padded: 45 hidden pad keys whose queries sit at
    position 0; row 1 with the positions of its rows 128..255 permuted
    among themselves), and T and S not multiples of 128 in a cached prefill
    (positions S-T..S-1, so the key tile 128..255 straddles the first query
    tile's mask-free boundary; row 1 hides key 5, so its tile 0 is masked
    while row 0's is not)."""
    rng = np.random.RandomState(11)
    T = S = 384
    pos = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    mask = np.ones((2, S), np.int32)
    pos[0, :45], mask[0, :45] = 0, 0
    pos[1, 128:256] = rng.permutation(np.arange(128, 256, dtype=np.int32))
    yield ("non-monotone positions (left pad; a permuted tile) T=S=384 H=8 KH=2", 8, 2,
           (pos, mask))
    T, S = 300, 437
    pos = np.tile(np.arange(S - T, S, dtype=np.int32), (2, 1))
    mask = np.ones((2, S), np.int32)
    mask[1, 5] = 0
    yield ("ragged T=300 S=437 (cached prefill) H=KH=8, a key hole in row 1", 8, 8, (pos, mask))


def _flash_edge_cases():
    """K1 on the two layouts of :func:`_flash_edge_layouts`."""
    for seed, (label, H, KH, (pos, mask)) in zip((12, 13), _flash_edge_layouts()):
        yield _flash_case(f"flash_fwd {label}", pos.shape[0], pos.shape[1], mask.shape[1], H, KH,
                          128, causal=True, layout=(pos, mask), seed=seed)


def check_flash_training(report: list, layout) -> None:
    """K1 at the training step's shape: the rows of the first batch phase 8's
    ``Trainer`` collates (B=4, T=S its bucket, H=KH=32, right-padded rows of
    different lengths), where K1 runs 64 times a step."""
    import torch

    from vcoder_tpu_torch.ops import flash_attention as fa

    pos, mask = layout
    B, T = pos.shape
    lens = [int(n) for n in np.asarray(mask).sum(axis=1)]
    case = _flash_case(f"flash_fwd training B={B} T={T} H=KH=32 rows {lens}", B, T, T, 32, 32,
                       128, causal=True, layout=layout, seed=14)
    case["report"] = "flash_fwd_train"
    check_flash(case, report)
    del case
    torch.cuda.empty_cache()
    fa.launches = 0  # comparison launches do not count


def check_training_13b(report: list, layout) -> None:
    """K1 and K6 at the 13B training step's shape: the rows of phase 8's
    first batch (``layout``: B=4, T=S its bucket) at H=KH=40, where a 13B
    step launches K1 80 times and K6 40 (phase 17). Gated as the 7B cases
    (K1 on max-abs and LSE, K6 on relative L2 per gradient and per 64-row
    tile, the output gradient 0 on pad rows), timed beside their bounds and
    SDPA, and noted under ``cases_13b`` on the ``flash_fwd_train`` and
    ``flash_bwd`` entries."""
    import torch

    from vcoder_tpu_torch.ops import flash_attention as fa

    pos, mask = layout
    B, T = pos.shape
    lens = [int(n) for n in np.asarray(mask).sum(axis=1)]
    case = _flash_case(f"flash_fwd 13B training B={B} T={T} H=KH=40 rows {lens}", B, T, T, 40,
                       40, 128, causal=True, layout=layout, seed=15)
    case["note"] = "flash_fwd_train"
    check_flash(case, report)
    del case
    case = _flash_bwd_case(f"flash_bwd 13B B={B} T={T} H=KH=40 rows {lens}", B, T, T, 40, 40,
                           layout=layout, seed=16)
    case["report"] = case["note"] = True
    check_flash_bwd(case, report)
    del case
    torch.cuda.empty_cache()
    fa.launches = fa.bwd_launches = 0  # comparison launches do not count


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


def build_model(size: str = "7b", device="cuda", quiet: bool = False, place=None):
    """VCoder-DS of ``size`` (``VCoderConfig.standard``'s "7b" or "13b")
    with seeded random bf16 weights and EOS off: 7B built once and shared
    by phases 4 to 12 (phase 15 builds it again on each of its ranks' cards,
    ``place`` sharding each leaf as it is drawn), 13B by phase 16. Returns
    (cfg, params, model, tokenizer)."""
    import torch

    from vcoder_tpu_torch.builder import VCoderForCausalLM
    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.models import vcoder as model_mod
    from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer

    cfg = VCoderConfig.standard("vcoder_ds_llava", size)
    # EOS off (an id argmax never emits): every request decodes all tokens.
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, eos_token_id=-1))
    t0 = time.perf_counter()
    params = model_mod.init_vcoder_params(cfg, seed=0, dtype=torch.bfloat16, device=device,
                                           place=place)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _flat(params).values())
    if not quiet:
        log(f"VCoder-DS-{size.upper()} random bf16 weights, {n_params / 1e9:.3f} B params, "
            f"init {time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    tok = SimpleTokenizer.build_from_texts([PROMPT])
    return cfg, params, VCoderForCausalLM(cfg, params), tok


def phase_main_path(cfg, params, model, tok, profile: bool = None) -> dict:
    """Phase 4 (and 16a, at 13B): the B=1 path of ``generate``, gated on one
    flash launch per decoder layer and 23 ViT blocks per prefill. Returns the
    launch counts, TTFT and decode p50 and the requests."""
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
                         tokens=seqs[0, :8].tolist(), pictures=pictures, ids=ids,
                         greedy=seqs[0].tolist()))
        log(f"  request {h}x{w}: {len(ids)} prompt ids, TTFT {ttft * 1e3:.1f} ms, "
            f"{max_new} tokens in {total * 1e3:.1f} ms, decode {decode_tps:.1f} tok/s, "
            f"first tokens {seqs[0, :8].tolist()}")
    n_flash, n_vit = fa.launches, va.launches
    ttft_p50 = float(np.median([r["ttft_ms"] for r in reqs]))
    decode_p50 = float(np.median([r["decode_tok_s"] for r in reqs]))
    log(f"  TTFT p50 {ttft_p50:.1f} ms, decode p50 {decode_p50:.1f} tok/s (B=1, host clock)")
    log(f"  launches over {prefills} prefills: flash_fwd {n_flash} ({n_flash / prefills:g} per "
        f"prefill), vit_block {n_vit} ({n_vit / prefills:g} per tower pass)")
    if n_flash != cfg.text.num_layers * prefills or n_vit != 23 * prefills:
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
    if "--profile" in sys.argv if profile is None else profile:
        profile_requests(model, tok, _images(np.random.RandomState(8), 480, 640))
    return {"flash_fwd": n_flash, "vit_block": n_vit, "ttft_p50_ms": ttft_p50,
            "decode_tok_s_p50": decode_p50, "requests": reqs}


ENGINE_SIZES = [(480, 640), (720, 540), (375, 500), (600, 800), (512, 384), (333, 444),
                (640, 480), (400, 600)]


def _prepared(ids, pictures, max_new, device="cuda"):
    """A PreparedRequest carrying the pictures as preprocessed numpy pixels
    [1, 336, 336, 3] (what a front end hands the worker), plus the same
    pixels as bf16 tensors for ``generate``."""
    import torch

    from vcoder_tpu_torch.preprocess import process_images
    from vcoder_tpu_torch.serve.chat import PreparedRequest

    px = [process_images([a], dtype=torch.bfloat16, device=device) for a in pictures]
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


def _run_engine(label, cfg, params, turns, *, max_new, profile_first=False, max_batch=8,
                model_name="vcoder_ds_llava-7b", **kw):
    """Build a paged engine and serve each turn -- a list of requests, or a
    function of the previous turn's results -- through
    EngineWorker.from_engine, every counter set to 0 just before the turn and
    read just after; then shut the worker down and close the engine. With
    ``profile_first`` the first turn runs under ``torch.profiler`` and
    ``stats["profile"]`` holds the device time of each paged kernel by name
    over it. Logs the served tokens' digest (a reading: batching may differ
    between runs). Returns (results per turn, stats)."""
    import torch

    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8
    from vcoder_tpu_torch.ops import paged_attention as pa
    from vcoder_tpu_torch.ops import vit_attention as va
    from vcoder_tpu_torch.serve.engine_server import EngineWorker
    from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine

    eng = PagedServingEngine(cfg, params, max_batch=max_batch, max_len=2048, page_size=64,
                             eos_id=-1, device="cuda", **kw)
    if kw.get("chunked_prefill"):
        eng.warmup_chunks()
    pool_gib = sum(t.numel() * t.element_size() for t in
                   (eng.k_pages, eng.v_pages, eng.k_scale, eng.v_scale) if t is not None) / 2**30
    worker = EngineWorker.from_engine(eng, model_name=model_name, eos_id=-1)
    results, walls, counts, decode = [], [], [], []
    paged_ms = None
    try:
        for turn in turns:
            prep_turn = turn(results[-1]) if callable(turn) else turn
            n_steps0 = len(eng.timer.samples.get("decode_step", []))
            _reset_counters()
            if profile_first and not results:
                from torch.autograd import DeviceType
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    res, wall = _drive(worker, prep_turn)
                    torch.cuda.synchronize()
                paged_ms, busy = {}, 0.0
                for e in prof.events():
                    if e.device_type == DeviceType.CUDA:
                        busy += e.time_range.elapsed_us() / 1e3
                        m = re.search(r"paged_attn_\w+<[^>]*>", e.name)
                        if m:
                            name = m.group(0)
                            ms, n = paged_ms.get(name, (0.0, 0))
                            paged_ms[name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
                paged_ms["device busy"] = (busy, 0)
            else:
                res, wall = _drive(worker, prep_turn)
            torch.cuda.synchronize()
            steps = eng.timer.samples.get("decode_step", [])[n_steps0:]
            counts.append(dict(flash=fa.launches, vit=va.launches, mlp=va.launches_mlp,
                               bf16=pa.launches_bf16, q8=pa.launches_q8, k8=pa.launches_k8,
                               fused=pa.launches_fused, by_window=dict(pa.launches_by_window),
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
    ttfts, rates = [], []
    for t, (res, wall, c, (dec_s, step_p50)) in enumerate(zip(results, walls, counts, decode)):
        bad = [r for r in res if r["err"] is not None or len(r["tokens"]) != max_new]
        if bad:
            raise SystemExit(f"engine {label}: requests did not complete: {bad[:2]}")
        ttft = np.median([r["ttft_s"] for r in res]) * 1e3
        ttfts.append(ttft)
        n_tok = sum(len(r["tokens"]) - 1 for r in res)
        rates.append(n_tok / dec_s)
        log(f"  engine {label} turn {t + 1}: {len(res)} requests x {max_new} tokens in "
            f"{wall:.2f} s; TTFT p50 {ttft:.1f} ms; aggregate decode {n_tok / dec_s:.1f} tok/s "
            f"({n_tok} tokens after the first over {dec_s:.2f} s of decode steps); per-step "
            f"wall p50 {step_p50:.2f} ms over {c['decode_dispatches']} steps; "
            f"launches {json.dumps(c)}")
    digest = hashlib.sha1(json.dumps([r["tokens"] for res in results for r in res])
                          .encode()).hexdigest()[:16]
    log(f"  engine {label}: pools {pool_gib:.2f} GiB, prefix {json.dumps(stats.get('prefix_cache'))}, "
        f"preemptions {stats.get('preemptions')}, tokens sha1 {digest}")
    return results, dict(counts=counts, prefix=stats.get("prefix_cache"), ttft_p50_ms=ttfts,
                         step_p50_ms=[d[1] for d in decode], decode_tok_s=rates, digest=digest,
                         profile=paged_ms, pool_gib=pool_gib)


# Engine C: speculative verify windows of 4, chunked prefill of 128, prefix cache.
ENGINE_C = dict(speculative=4, chunked_prefill=128, prefix_cache=True)


def engine_c_turn2(preps, tok):
    """Engine C's second turn: the first 4 conversations, each extended by
    its first answer and a follow-up question."""
    extra = tok.encode("what else can be seen")[1:]

    def turn2(turn1):
        return [dataclasses.replace(p, input_ids=list(p.input_ids) + r["tokens"] + extra)
                for p, r in zip(preps[:4], turn1)]

    return turn2


def profile_engine_chunks(cfg, params, preps, tag: str = "profile_engine_chunks") -> dict:
    """``--profile``: engine C's first turn (4 admissions through chunked
    prefill windows of 128, then verify windows of 4) under torch.profiler:
    the paged kernels' device time and launches by kernel name beside the
    turn's TTFT p50 and launches by window. Printed as one ``<tag>: {...}``
    JSON line."""
    _, st = _run_engine(f"C profiled ({tag})", cfg, params, [preps[:4]], max_new=32,
                        profile_first=True, **ENGINE_C)
    out = dict(ttft_p50_ms=st["ttft_p50_ms"][0], by_window=st["counts"][0]["by_window"],
               paged_ms_by_kernel={k: [round(v[0], 4), v[1]] for k, v in st["profile"].items()})
    log(f"{tag}: " + json.dumps(out))
    return out


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

    if "--profile" in sys.argv:
        profile_engine_decode(cfg, preps, [("engine_bf16_decode_step", params, {}),
                                           ("engine_int8_decode_step", params,
                                            {"kv_quant": True})])
        profile_engine_chunks(cfg, params, preps)
    _, st_c = _run_engine("C (speculative 4, chunked prefill 128, prefix cache)", cfg, params,
                          [preps[:4], engine_c_turn2(preps, tok)], max_new=max_new, **ENGINE_C)
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
    return totals, dict(preps=preps, results=res_a, stats=st_a)


@contextlib.contextmanager
def plain_quant_route():
    """The plain route of the quantized matmuls, for a reading of the
    kernel route against it: ``qmatmul`` calls the int4 and W8A8 products
    through their modules, so pointing those names at the plain versions
    (which take the same arguments, the int4 product's scale included)
    swaps the route (the wrappers themselves only ever launch on CUDA).
    Fails if any kernel launched inside, so that a reading of the kernel
    route cannot quietly compare the kernels with themselves."""
    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8
    from vcoder_tpu_torch.ops import paged_attention as pa
    from vcoder_tpu_torch.ops import vit_attention as va

    def counts():
        return (fa.launches, va.launches, va.launches_mlp, i4.launches, i8.launches,
                i8.launches_scaled, pa.launches_bf16, pa.launches_q8, pa.launches_k8,
                pa.launches_fused)

    before = counts()
    saved = i4.int4_matmul, i8.int8_mm_scaled
    i4.int4_matmul, i8.int8_mm_scaled = i4.int4_matmul_ref, i8.int8_mm_scaled_ref
    try:
        yield
    finally:
        i4.int4_matmul, i8.int8_mm_scaled = saved
    if counts() != before:
        raise SystemExit(f"plain route launched kernels: counts {before} -> {counts()}")


def _prefill_routes(params, cfg, tok, pictures, plain: bool = True):
    """Last-token prefill logits of one DS request through the kernels and
    (with ``plain``) through the plain route (plain attention, plain
    quantized products)."""
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
        lp = None
        if plain:
            with plain_quant_route():
                lp, _ = model_mod.prefill(params, cfg, arrays, *px, use_vcoder_emb=True,
                                          attn_impl="xla")
    torch.cuda.synchronize()
    return lk, lp, plan


# Engines D's and E's token digests as last recorded (H100 80GB HBM3): a
# reading, since batching may differ between runs, and a change of the
# paged kernel's rounding order changes them.
QUANT_DIGESTS = {"D": "de744a320f4b8b76", "E": "3571acdd503af2a2"}


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
        earlier = QUANT_DIGESTS[label[0]]
        same = "same as" if st["digest"] == earlier else "differs from"
        log(f"  engine {label}: tokens sha1 {same} {earlier}, the digest last recorded")
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


QUESTIONS = ["What objects can be seen in the image?", "What is in the image?",
             "Which objects are present, and in what depth order?",
             "Describe the objects you can perceive."]
OBJECTS = ["person", "car", "wall", "tree", "sky", "road", "dog", "bench", "window", "grass",
           "building", "bicycle", "table", "chair", "lamp"]


class DSSamples:
    """An in-memory stage-3 dataset with the interface the Trainer reads
    (that of the JAX package's ``VCoderDataset``): ``n`` VCoder-DS samples,
    each a ``<depth>\n<seg>\n<image>\n`` question and an answer of 6-24
    object words, tokenized by the port's ``train/preprocess`` with a
    word-level tokenizer, and three ``size`` x ``size`` pictures (RGB, seg,
    depth) drawn from a numpy seed and normalized like CLIP's processor."""

    def __init__(self, n: int, size: int = 336, seed: int = 0):
        from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer
        from vcoder_tpu_torch.train.preprocess import preprocess

        rng = np.random.RandomState(seed)
        self.tokenizer = SimpleTokenizer()
        mean = np.asarray([0.48145466, 0.4578275, 0.40821073], np.float32)
        std = np.asarray([0.26862954, 0.26130258, 0.27577711], np.float32)
        self.samples, self.modality_lengths = [], []
        for _ in range(n):
            q = QUESTIONS[rng.randint(len(QUESTIONS))]
            words = rng.choice(OBJECTS, rng.randint(6, 25))
            answer = "The objects present in the image are: " + ", ".join(words) + "."
            conv = [{"from": "human", "value": f"<depth>\n<seg>\n<image>\n{q}"},
                    {"from": "gpt", "value": answer}]
            data = preprocess([conv], self.tokenizer, has_image=True, has_seg=True,
                              has_depth=True, version="llava_v1")
            pics = [(rng.randint(0, 256, (size, size, 3)).astype(np.float32) / 255.0 - mean) / std
                    for _ in range(3)]
            self.samples.append(dict(input_ids=data["input_ids"][0], labels=data["labels"][0],
                                     image=pics[0], seg=pics[1], depth=pics[2]))
            self.modality_lengths.append(sum(len(c["value"].split()) for c in conv))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        return self.samples[i]


def train_args(output_dir: str):
    """Phase 8's ``TrainArgs``: stage ``vcoder_ds``, B=4, ``remat="dots"``
    (the JAX drivers' defaults), no checkpoint within the run."""
    from vcoder_tpu_torch.train.trainer import TrainArgs

    return TrainArgs(output_dir=output_dir, stage="vcoder_ds", per_device_train_batch_size=4,
                     remat="dots", save_steps=10**9, dataloader_workers=4)


def training_layout(cfg, ds):
    """(positions [B,T], key mask [B,T]) as numpy int32: the rows of the
    first batch phase 8's ``Trainer`` collates from ``ds`` (its sampler
    order and bucket, through ``train.trainer.epoch_batches``, on the CPU)."""
    from vcoder_tpu_torch.train.trainer import epoch_batches

    batches = epoch_batches(cfg, ds, train_args(""), 0, device="cpu")  # writes nothing
    batch = next(batches)
    batches.close()
    return (batch["position_ids"].numpy().astype(np.int32),
            batch["attn_mask"].numpy().astype(np.int32))


def _with_cloned(tree, paths, prefix=""):
    """``tree`` with the leaves at ``paths`` cloned (others shared)."""
    if isinstance(tree, dict):
        return {k: _with_cloned(v, paths, f"{prefix}/{k}" if prefix else k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_cloned(v, paths, f"{prefix}/{i}") for i, v in enumerate(tree)]
    return tree.clone() if prefix in paths else tree


# Kernel route against plain route: the bound on the relative L2 of the
# trainable gradients of one B=1 sample through 32 bf16 layers of random
# weights. Sound runs read ~0.055 (bf16 prefill logits read 0.049 the same
# way); a planted K6 fault reads at most PERF.md's figures, most of them
# under the bound: this gate catches a cut or grossly wrong gradient, and
# phase 3's K6 gates are the check of the kernel itself.
GRAD_ROUTE_REL_L2 = 0.2


def route_agreement(cfg, params, ds, T, stage, plain=None, device="cuda") -> dict:
    """The kernel route's trainable gradients against the plain route's on
    one sample (``ds[0]`` padded to ``T``) through every layer with
    per-layer remat: ``attn_impl="auto"`` (the kernels) against ``"xla"``
    (plain torch, which must launch no kernel). ``plain``: the plain
    route's (loss, gradients) from an earlier call on the same weights.
    Returns the relative L2 over all trainable gradients and per leaf, both
    losses, and ``plain``."""
    import torch

    from vcoder_tpu_torch.models import vcoder as model_mod
    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.ops import vit_attention as va
    from vcoder_tpu_torch.train.collator import collate_batch
    from vcoder_tpu_torch.train.step import trainable_leaves

    batch = collate_batch([ds[0]], num_patches=cfg.vision.num_patches, ds_mode=True,
                          use_seg=True, use_depth=True, image_size=cfg.vision.image_size,
                          pad_to=T, device=device)
    leaves = trainable_leaves(params, stage)

    def route_grads(attn_impl):
        loss = model_mod.train_forward(params, cfg, batch, batch["images"], batch["segs"],
                                       batch["depths"], use_vcoder_emb=True,
                                       attn_impl=attn_impl, remat=True)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return loss.item(), {k: g for k, g in zip(leaves, grads) if g is not None}

    lk, gk = route_grads("auto")
    if plain is None:
        before = (fa.launches, fa.bwd_launches, va.launches)
        plain = route_grads("xla")
        if (fa.launches, fa.bwd_launches, va.launches) != before:
            raise SystemExit("training phase: the plain route launched kernels")
    lp, gp = plain
    if set(gk) != set(gp):
        raise SystemExit(f"training phase: the routes differentiate other leaves "
                         f"({sorted(gk)} vs {sorted(gp)})")
    _sync(device)
    num = sum((gk[k].float() - gp[k].float()).square().sum() for k in gp)
    den = sum(gp[k].float().square().sum() for k in gp)
    per_leaf = {k: ((gk[k].float() - gp[k].float()).norm() / gp[k].float().norm()).item()
                for k in gp}
    return dict(rel=(num / den).sqrt().item(), per_leaf=per_leaf, loss_kernel=lk,
                loss_plain=lp, plain=plain)


def phase_training(cfg, params, ds, layout) -> dict:
    """Phase 8: stage-3 adapter training at full width through ``Trainer``:
    VCoder-DS-7B's seg projector, depth projector and ``vcoder_lm_emb``
    trained over the frozen bf16 base, 4 steps of B=4 with ``remat="dots"``.
    The trainable leaves are cloned first, so later phases see the untouched
    weights. Gates: finite losses and grad norms; step 1's seg-projector and
    ``vcoder_lm_emb`` gradients non-zero and the depth projector's exactly 0;
    step 1 leaves the weights as they were (lr 0) and step 2 moves them;
    per step 32 K6 backward calls, 64 K1 launches (32 + 32 recomputed),
    23 ViT-block launches (the frozen tower, no grad), and no launch of a
    kernel without a backward; step 1's rows are phase 3's K6 case
    (``layout``); then the kernel route's trainable gradients against the
    plain route's on one sample. Returns the launch counts."""
    import torch

    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8
    from vcoder_tpu_torch.ops import paged_attention as pa
    from vcoder_tpu_torch.ops import vit_attention as va
    from vcoder_tpu_torch.train.collator import collate_batch
    from vcoder_tpu_torch.train.step import trainable_leaves
    from vcoder_tpu_torch.train.trainer import Trainer

    steps = 4
    records = []
    with tempfile.TemporaryDirectory() as out:
        args = train_args(out)
        stage, B = args.stage, args.per_device_train_batch_size
        tparams = _with_cloned(params, set(trainable_leaves(params, stage)))
        initial = {p: t.clone() for p, t in trainable_leaves(tparams, stage).items()}
        trainer = Trainer(cfg, tparams, ds, args, device="cuda")
        inner = trainer.step_fn

        def timed_step(p, state, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            res = inner(p, state, batch)
            end.record()
            torch.cuda.synchronize()
            leaves = trainable_leaves(p, stage)
            records.append(dict(
                ms=start.elapsed_time(end), T=int(batch["safe_ids"].shape[1]),
                rows=(batch["position_ids"].cpu().numpy(), batch["attn_mask"].cpu().numpy()),
                tokens=int(batch["attn_mask"].sum()),
                labels=int((batch["labels"][:, 1:] != -100).sum()),
                leaf_norms={k: float(v) for k, v in res[2]["leaf_grad_norms"].items()},
                moved=[k for k, t in leaves.items() if not torch.equal(t, initial[k])]))
            return res

        trainer.step_fn = timed_step
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gib = torch.cuda.memory_allocated() / 2**30
        fa.launches = fa.bwd_launches = va.launches = i4.launches = 0
        pa.reset_launches()
        i8.reset_launches()
        t0 = time.perf_counter()
        history = trainer.train(max_steps=steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(flash_fwd=fa.launches, flash_bwd=fa.bwd_launches, vit_block=va.launches,
                      paged_bf16=pa.launches_bf16, paged_q8=pa.launches_q8,
                      paged_k8=pa.launches_k8, int4=i4.launches, int8=i8.launches,
                      int8_scaled=i8.launches_scaled)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if "--profile" in sys.argv:
            # One more step of the same shape, after the counters were read.
            batch = collate_batch(ds.samples[:B], num_patches=cfg.vision.num_patches,
                                  ds_mode=True, use_seg=True, use_depth=True,
                                  image_size=cfg.vision.image_size, pad_to=records[0]["T"],
                                  device="cuda")
            prof = _profile("train_step", lambda: inner(tparams, trainer.opt_state, batch))
            log("profile_train: " + json.dumps({"train_step": prof}))
        del trainer
    for h, r in zip(history, records):
        log(f"  train step {h['step']}: T={r['T']} B={B}, {r['tokens']} tokens "
            f"({r['labels']} labels), {r['ms']:.1f} ms (CUDA events), "
            f"{r['tokens'] / r['ms'] * 1e3:.0f} tokens/s, loss {h['loss']:.4f}, "
            f"grad_norm {h['grad_norm']:.4f}")
    ms_p50 = float(np.median([r["ms"] for r in records[1:]]))
    tok_s = float(np.median([r["tokens"] / r["ms"] * 1e3 for r in records[1:]]))
    log(f"  training: {steps} steps in {wall:.1f} s; steps 2-{steps} p50 {ms_p50:.1f} ms, "
        f"{tok_s:.0f} tokens/s; peak {peak_gib:.2f} GiB allocated ({base_gib:.2f} GiB before); "
        f"step-1 grad norms {json.dumps(records[0]['leaf_norms'])}; launches {json.dumps(counts)}")
    bad = []
    if len(history) != steps or not all(np.isfinite([h["loss"], h["grad_norm"]]).all()
                                        for h in history):
        bad.append("non-finite loss or grad_norm")
    norms = records[0]["leaf_norms"]
    if not (all(v > 0 for k, v in norms.items() if k.startswith("seg_projector/"))
            and norms["vcoder_lm_emb"] > 0):
        bad.append("zero seg_projector / vcoder_lm_emb gradient on step 1")
    if any(v != 0 for k, v in norms.items() if k.startswith("depth_projector/")):
        bad.append("non-zero depth_projector gradient (depth goes through the seg projector)")
    if records[0]["moved"] or not {"seg_projector/w/0", "vcoder_lm_emb"} <= set(records[1]["moved"]):
        bad.append(f"weights moved {records[0]['moved']} after step 1 (lr 0) / "
                   f"{records[1]['moved']} after step 2")
    want = dict(flash_fwd=64 * steps, flash_bwd=32 * steps, vit_block=23 * steps, paged_bf16=0,
                paged_q8=0, paged_k8=0, int4=0, int8=0, int8_scaled=0)
    if counts != want:
        bad.append(f"launches {counts} != {want}")
    if not all(np.array_equal(a, b) for a, b in zip(records[0]["rows"], layout)):
        bad.append("step 1's rows are not phase 3's K6 case")
    if bad:
        raise SystemExit("training phase: " + "; ".join(bad))

    # Kernel route against plain route on one sample, per-layer remat.
    r = route_agreement(cfg, tparams, ds, records[0]["T"], stage)
    ok = r["rel"] <= GRAD_ROUTE_REL_L2
    log(f"  B=1 T={records[0]['T']}: kernel vs plain route loss {r['loss_kernel']:.5f} vs "
        f"{r['loss_plain']:.5f}, trainable gradients rel L2 {r['rel']:.3e} (bound "
        f"{GRAD_ROUTE_REL_L2}) per leaf "
        f"{json.dumps({k: round(v, 4) for k, v in r['per_leaf'].items()})} -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("training phase: kernel route gradients disagree with the plain route")
    del tparams, initial, r
    torch.cuda.empty_cache()
    return dict(counts=counts, step_ms_p50=ms_p50, tokens_s=tok_s, peak_gib=peak_gib)


LORA_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")

# The K9 route's prefill logits against the unfused MLP's on one request:
# the two round at other places (after the GELU, after fc1), and through 23
# blocks and 32 layers of random bf16 weights a difference of that kind
# reads ~0.05 relative L2 (the kernel against the plain route, PERF.md).
MLP_ROUTE_REL_L2 = 0.15


def lora_dims(t) -> dict:
    """(in, out) of each LoRA target of a text config."""
    q, kv = t.num_heads * t.head_dim, t.num_kv_heads * t.head_dim
    return dict(q_proj=(t.hidden_size, q), k_proj=(t.hidden_size, kv),
                v_proj=(t.hidden_size, kv), o_proj=(q, t.hidden_size),
                gate_proj=(t.hidden_size, t.intermediate_size),
                up_proj=(t.hidden_size, t.intermediate_size),
                down_proj=(t.intermediate_size, t.hidden_size))


def make_adapters(cfg, seed: int = 21) -> dict:
    """Two seeded adapters over q/k/v/o/gate/up/down of every decoder layer,
    ``a`` of rank 16 and ``b`` of rank 8, bf16 on the card: A ~ N(0, 1/in),
    B ~ N(0, 0.02^2), alpha = 2 r, so each adds a delta of ~10% of the base
    weight's size and moves greedy tokens."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = cfg.text
    dims = lora_dims(t)
    out = {}
    for name, rank in (("a", 16), ("b", 8)):
        tree = {}
        for proj in LORA_TARGETS:
            din, dout = dims[proj]
            a = torch.randn((t.num_layers, din, rank), generator=gen, device="cuda",
                            dtype=torch.bfloat16) * din**-0.5
            b = torch.randn((t.num_layers, rank, dout), generator=gen, device="cuda",
                            dtype=torch.bfloat16) * 0.02
            tree[f"lm/layers/{proj}"] = (a, b, 2.0)
        out[name] = tree
    return out


def phase_fused_lora(cfg, params, model, tok, engine_a, main_ttft_ms) -> dict:
    """Phase 9, full width, the phase-4 weights: engine F is engine A's
    traffic with ``FUSED_APPEND`` on (K7 at window 1 in every layer of every
    decode step; the A/B against phase 6's engine A); engine G serves int8
    pools, ``speculative=4``, ``FUSED_APPEND`` and ``FUSE_MLP_DEFAULT`` on
    and two seeded adapters, rows 3 x ``a``, 3 x ``b``, 2 x none, beside
    engine G0, the same configuration and requests without adapters; then
    phase 4's 3 requests through ``generate`` with ``FUSE_MLP_DEFAULT`` on
    (the tower A/B). Both flags are restored after. Returns launch totals."""
    import torch

    from vcoder_tpu_torch.models import clip as clip_mod
    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.ops import paged_attention as pa
    from vcoder_tpu_torch.ops import vit_attention as va

    max_new = 32
    preps = engine_a["preps"]
    n = len(preps)
    totals = dict(fused=0, mlp=0)
    try:
        pa.FUSED_APPEND = True
        (res_f,), st_f = _run_engine("F (bf16 pools, FUSED_APPEND)", cfg, params, [preps],
                                     max_new=max_new)
        cf = st_f["counts"][0]
        d = cf["decode_dispatches"]
        if cf["fused"] != 32 * d or cf["by_window"] != {1: 32 * d} or cf["k8"] or cf["bf16"] \
                or cf["q8"] or cf["flash"] != 32 * n or cf["vit"] != 23 * n or cf["mlp"]:
            raise SystemExit(f"engine F: launches {cf} != 32 K7 per decode step, no K8/K3/K4")
        first_a = [r["tokens"][0] for r in engine_a["results"]]
        first_f = [r["tokens"][0] for r in res_f]
        if first_f != first_a:
            raise SystemExit(f"engines F and A disagree on first tokens: {first_f} vs {first_a}")
        agree = sum(int(x == y) for ra, rf in zip(engine_a["results"], res_f)
                    for x, y in zip(ra["tokens"][1:], rf["tokens"][1:]))
        sa = engine_a["stats"]
        log(f"  A/B fused append: F vs A decode tokens {agree}/{n * (max_new - 1)} agree, first "
            f"tokens equal; step wall p50 {st_f['step_p50_ms'][0]:.2f} ms (A "
            f"{sa['step_p50_ms'][0]:.2f} ms), TTFT p50 {st_f['ttft_p50_ms'][0]:.1f} ms (A "
            f"{sa['ttft_p50_ms'][0]:.1f} ms), launches per step: K7 32 (A: K8 32 + 64 "
            f"append scatters)")
        totals["fused"] += cf["fused"]
        if "--profile" in sys.argv:
            profile_engine_decode(cfg, preps, [("engine_F_decode_step", params, {})],
                                  tag="profile_engine_fused")

        clip_mod.FUSE_MLP_DEFAULT = True
        lora = ["a"] * 3 + ["b"] * 3 + [None] * 2
        preps_g = [dataclasses.replace(p, lora=name) for p, name in zip(preps, lora)]
        kw = dict(max_new=max_new, kv_quant=True, speculative=4)
        (res_g,), st_g = _run_engine("G (int8 pools, speculative 4, FUSED_APPEND, FUSE_MLP, "
                                     "adapters a/b)", cfg, params, [preps_g],
                                     lora_adapters=make_adapters(cfg), **kw)
        (res_0,), st_0 = _run_engine("G0 (G without adapters)", cfg, params, [preps], **kw)
        for label, c in (("G", st_g["counts"][0]), ("G0", st_0["counts"][0])):
            d = c["decode_dispatches"]
            if (c["fused"] != 32 * d or c["by_window"] != {4: 32 * d} or c["q8"] or c["bf16"]
                    or c["k8"] or c["mlp"] != 23 * n or c["vit"] != 23 * n
                    or c["flash"] != 32 * n):
                raise SystemExit(f"engine {label}: launches {c} != 32 K7 per verify step (no K4) "
                                 f"and 23 K9 per admission")
            totals["fused"] += c["fused"]
            totals["mlp"] += c["mlp"]
        toks_g = [r["tokens"] for r in res_g]
        toks_0 = [r["tokens"] for r in res_0]
        moved = {name: sum(int(toks_g[i] != toks_0[i]) for i in range(n) if lora[i] == name)
                 for name in ("a", "b")}
        same_none = all(toks_g[i] == toks_0[i] for i in range(n) if lora[i] is None)
        log(f"  G vs G0: no-adapter rows equal {same_none}; rows whose tokens the adapter "
            f"changed {json.dumps(moved)} of 3 each")
        if not same_none or not all(moved.values()):
            raise SystemExit("engine G: no-adapter rows differ from G0, or an adapter changed "
                             "no row's tokens")

        # The B=1 path with the MLP kernel: phase 4's requests (same draws).
        rng = np.random.RandomState(0)
        _images(rng, 300, 420)
        fa.launches = va.launches = va.launches_mlp = 0
        ttfts = []
        for h, w in [(480, 640), (720, 540), (375, 500)]:
            pictures = _images(rng, h, w)
            t0 = time.perf_counter()
            _, res = _serve(model, tok, pictures, 1)
            ttfts.append((time.perf_counter() - t0) * 1e3)
        c = dict(flash=fa.launches, vit=va.launches, mlp=va.launches_mlp)
        if c != dict(flash=32 * 3, vit=23 * 3, mlp=23 * 3):
            raise SystemExit(f"B=1 with FUSE_MLP: launches {c} != 32/23/23 per request")
        totals["mlp"] += c["mlp"]
        pictures = _images(np.random.RandomState(7), 480, 640)
        lk_on, _, _ = _prefill_routes(params, cfg, tok, pictures, plain=False)
        clip_mod.FUSE_MLP_DEFAULT = False
        lk_off, _, _ = _prefill_routes(params, cfg, tok, pictures, plain=False)
        rel = ((lk_on - lk_off).norm() / lk_off.norm()).item()
        ok = rel <= MLP_ROUTE_REL_L2 and bool(torch.isfinite(lk_on).all())
        log(f"  A/B fused MLP, B=1: TTFT p50 {np.median(ttfts):.1f} ms (phase 4, unfused: "
            f"{main_ttft_ms:.1f} ms); launches {json.dumps(c)}; prefill logits K9 route vs "
            f"unfused MLP rel L2 {rel:.3e} (bound {MLP_ROUTE_REL_L2}), argmax "
            f"{int(lk_on.argmax())} vs {int(lk_off.argmax())} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("B=1 with FUSE_MLP: prefill logits too far from the unfused MLP's")
    finally:
        pa.FUSED_APPEND = False
        clip_mod.FUSE_MLP_DEFAULT = False
    torch.cuda.empty_cache()
    return totals


def _kernel_class(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_fwd (port)"
    if "flash_bwd" in name:
        return "flash_bwd (port)"
    if "gemm_sm90<0" in name:  # the bias epilogue: K2's GEMMs
        return "gemm_bias (port)"
    if "ln_kernel" in name or "gemm_sm90" in name:
        return "vit_mlp (port)"
    if "paged_attn" in name:
        return "paged_attn (port)"
    if "int4_matmul" in name:
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


def write_over_base_dirs(tmp: str, base: str, cfg, params, tok) -> tuple:
    """Next to the checkpoint ``base``: a PEFT LoRA directory (seeded rank-4
    adapters on q/k/v/o/gate/up/down, ``adapter_config.json``, a
    ``non_lora_trainables.bin`` mm-projector in the reference's prefixed
    keys) and an adapter-only directory (projector weights under bare,
    'model.' and 'base_model.model.' prefixes). Returns their paths."""
    import shutil

    import torch

    from vcoder_tpu_torch.checkpoint import write_safetensors

    rng = np.random.RandomState(9)
    f = lambda *s: torch.from_numpy((rng.randn(*s) * 0.05).astype(np.float32))  # noqa: E731
    t = cfg.text
    dims = lora_dims(t)
    lora, adapter = f"{tmp}/vcoder_ds_llava-smoke-lora", f"{tmp}/vcoder_ds_llava-smoke-adapter"
    state = {}
    for i in range(t.num_layers):
        for proj in LORA_TARGETS:
            mod = "mlp" if proj in ("gate_proj", "up_proj", "down_proj") else "self_attn"
            pre = f"base_model.model.model.layers.{i}.{mod}.{proj}"
            din, dout = dims[proj]
            state[f"{pre}.lora_A.weight"] = f(4, din)
            state[f"{pre}.lora_B.weight"] = f(dout, 4)
    mm0 = tuple(params["mm_projector"]["w"][0].shape)[::-1]  # HF [out, in]
    seg0 = tuple(params["seg_projector"]["w"][0].shape)[::-1]
    for d in (lora, adapter):
        os.makedirs(d)
        shutil.copy(os.path.join(base, "config.json"), d)
        tok.save_pretrained(d)
    write_safetensors(f"{lora}/adapter_model.safetensors", state)
    with open(f"{lora}/adapter_config.json", "w") as fh:
        json.dump({"r": 4, "lora_alpha": 8}, fh)
    torch.save({"base_model.model.model.mm_projector.0.weight": f(*mm0)},
               f"{lora}/non_lora_trainables.bin")
    write_safetensors(f"{adapter}/mm_projector.safetensors", {
        "model.mm_projector.0.weight": f(*mm0), "mm_projector.0.bias": f(mm0[0]),
        "base_model.model.model.seg_mm_projector.0.weight": f(*seg0)})
    return lora, adapter


def phase_checkpoint() -> None:
    """The checkpoint entry point: a small DS checkpoint saved, then loaded
    on the card five ways -- bf16, ``load_4bit``, ``load_8bit``, and as the
    base of a PEFT LoRA directory (merged) and of an adapter-only directory
    (overlaid), both through ``model_base`` -- and served through
    ``generate``; each variant's prefill logits through the kernels agree
    with the plain route."""
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
        lora, adapter = write_over_base_dirs(tmp, path, cfg, params, tok)
        for label, kw, mpath in (("bf16", {}, path), ("load_4bit", {"load_4bit": True}, path),
                                 ("load_8bit", {"load_8bit": True}, path),
                                 ("peft_lora", {"model_base": path}, lora),
                                 ("adapter_only", {"model_base": path}, adapter)):
            tokenizer, model, proc, seg_proc, depth_proc, ctx = load_pretrained_model(mpath, **kw)
            if seg_proc is None or depth_proc is None or model.device.type != "cuda":
                raise SystemExit("checkpoint: wrong processors or device")
            if not kw:
                saved, loaded = _flat(params), _flat(model.params)
                if saved.keys() != loaded.keys() or not all(
                    torch.equal(saved[k].to(torch.bfloat16), loaded[k]) for k in saved
                ):
                    raise SystemExit("checkpoint: loaded weights differ from the saved ones")
            if "model_base" in kw:
                # The adapters changed what they target and nothing else.
                saved, loaded = _flat(params), _flat(model.params)
                changed = {k for k in saved if not torch.equal(saved[k].to(torch.bfloat16),
                                                               loaded[k])}
                want = ({f"/lm/layers/{p}" for p in LORA_TARGETS} | {"/mm_projector/w/0"}
                        if label == "peft_lora" else
                        {"/mm_projector/w/0", "/mm_projector/b/0", "/seg_projector/w/0"})
                if changed != want:
                    raise SystemExit(f"checkpoint {label}: changed leaves {sorted(changed)}")
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
            log(f"checkpoint {label}: loaded {mpath.rsplit('/', 1)[-1]} via "
                f"load_pretrained_model, tokens {res.sequences[0].tolist()}, int4_matmul "
                f"launches in generate {n_int4}, prefill logits kernel vs plain route "
                f"max_abs_err {err:.3e} (tol {tol:.3e}) -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"checkpoint phase failed ({label})")
            del model


# Phase 10: the checkpoint directory's name routes Chat (seg and depth from
# "vcoder" and "ds"); the CLI's first turn is PROMPT.
SURFACE_DIR = "vcoder_ds_llava-v1.5-7b"
CLI_TURNS = ("What objects can be seen in the image? Perceive as done for panoptic "
             "segmentation.\nWhat else can be seen?\n\n")
SURFACE_NEW = 32


def _reset_counters() -> None:
    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8
    from vcoder_tpu_torch.ops import paged_attention as pa
    from vcoder_tpu_torch.ops import vit_attention as va

    fa.launches = fa.bwd_launches = va.launches = va.launches_mlp = i4.launches = 0
    pa.reset_launches()
    i8.reset_launches()


def _counters() -> dict:
    """Every launch counter: K1, K6 calls, K2, K9, K8, the paged kernels
    (any body), K5, K10 in both forms."""
    from vcoder_tpu_torch.ops import flash_attention as fa
    from vcoder_tpu_torch.ops import int4_matmul as i4
    from vcoder_tpu_torch.ops import int8_matmul as i8
    from vcoder_tpu_torch.ops import paged_attention as pa
    from vcoder_tpu_torch.ops import vit_attention as va

    return dict(flash=fa.launches, flash_bwd=fa.bwd_launches, vit=va.launches,
                mlp=va.launches_mlp, k8=pa.launches_k8,
                paged=pa.launches_bf16 + pa.launches_q8 + pa.launches_k8 + pa.launches_fused,
                int4=i4.launches, int8=i8.launches, int8_scaled=i8.launches_scaled)


def _dense_gate(label: str, prefills: int) -> dict:
    """The counters of a dense path (generate, beams, streams, Chat): 32
    flash launches per prefill, 23 ViT blocks per tower pass, no paged one."""
    c = _counters()
    if c["flash"] != 32 * prefills or c["vit"] != 23 * prefills or c["paged"]:
        raise SystemExit(f"surfaces {label}: launches {c} over {prefills} prefills, want "
                         f"32 flash and 23 ViT each and no paged launch")
    return c


def full_vocab_tokenizer(cfg):
    """PROMPT's words, then one word per remaining id (``x<id>``): every
    generated token decodes to a word of its own, so served text shows the
    tokens. PROMPT's ids equal phase 4's tokenizer's."""
    from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer

    tok = SimpleTokenizer.build_from_texts([PROMPT])
    for i in range(len(tok.vocab), cfg.text.vocab_size):
        tok.convert_tokens_to_ids(f"x{i}")
    return tok


def _digest(obj) -> str:
    return hashlib.sha1(json.dumps(obj).encode()).hexdigest()[:16]


def _replay_gaps(params, cfg, ids, px, tokens) -> list:
    """``tokens``, a continuation of ``ids``, on two routes of the model with
    ``tokens`` themselves as the prefix: decode steps (prefill, then one
    step per token, each fed its predecessor) and one forward over the
    whole sequence, as training runs it. At every generated index ``j``:
    the decode row's top logit less its logit of ``tokens[j]`` (0 on a
    greedy path), the largest difference between the two routes' rows (the
    rounding spread of two correct routes there), and one bf16 ulp of the
    top logit."""
    import math

    import torch

    from vcoder_tpu_torch import generation as gen_mod
    from vcoder_tpu_torch.models import llama as llama_mod
    from vcoder_tpu_torch.models import vcoder as model_mod

    use_emb = cfg.use_vcoder_lm_emb
    with torch.no_grad():
        _, plan, arrays, im, sg, dp = gen_mod._prepare_inputs(params, cfg, [ids], *px)
        logits, cache = gen_mod._prefill(params, cfg, arrays, im, sg, dp,
                                         cache_len=plan.seq_len + len(tokens),
                                         use_vcoder_emb=plan.use_vcoder_emb and use_emb,
                                         attn_impl="auto")
        rows = [logits[0].float()]
        for j in range(1, len(tokens)):
            prev = torch.tensor([tokens[j - 1]], device=logits.device)
            logits, cache = model_mod.decode_step(params, cfg, prev, arrays["seq_lens"] + j - 1,
                                                  cache)
            rows.append(logits[0].float())
        _, plan2, a2, im, sg, dp = gen_mod._prepare_inputs(params, cfg, [ids + tokens[:-1]], *px)
        emb = model_mod.assemble_embeddings(
            params, cfg, a2["safe_ids"], a2["is_text"], a2["vis_idx"],
            model_mod.encode_vision(params, cfg, im, sg, dp, attn_impl="auto"),
            use_vcoder_emb=plan2.use_vcoder_emb and use_emb)
        hidden, _ = llama_mod.llama_forward(params["lm"], cfg.text, emb,
                                            attn_mask=a2["attn_mask"],
                                            position_ids=a2["position_ids"], attn_impl="auto")
        s0 = int(arrays["seq_lens"][0]) - 1
        whole = llama_mod.lm_head(params["lm"], hidden[:, s0 : s0 + len(tokens)])[0].float()
    out = []
    for j, t in enumerate(tokens):
        top = rows[j].max().item()
        out.append((top - rows[j][t].item(), (rows[j] - whole[j]).abs().max().item(),
                    2.0 ** (math.floor(math.log2(abs(top))) - 7)))
    return out


def surface_modes(cfg, params, model, tok, reqs) -> dict:
    """Phase 10 (a): lookahead, beams and streams on phase 4's requests,
    in memory, greedy with EOS off, each gated on its launch counters."""
    import torch

    from vcoder_tpu_torch import generation as gen_mod
    from vcoder_tpu_torch import speculative as spec
    from vcoder_tpu_torch.preprocess import process_images

    n = SURFACE_NEW
    totals = dict(flash=0, vit=0, k8=0)

    def add(c):
        for k in totals:
            totals[k] += c[k]

    out = []
    for i, r in enumerate(reqs):
        ids, greedy = r["ids"], r["greedy"]
        px = [process_images([a], dtype=torch.bfloat16, device="cuda") for a in r["pictures"]]
        _reset_counters()
        t0 = time.perf_counter()
        look = model.generate([ids], *px, max_new_tokens=n, lookahead=8).sequences[0].tolist()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        add(_dense_gate(f"lookahead request {i}", 1))
        j = next((k for k in range(n) if look[k] != greedy[k]), None)
        # Every one of lookahead's tokens, on its own prefix. Its verify
        # windows round otherwise than decode steps, so near a tie it may
        # take the decode path's runner-up: a token is accepted where it is
        # the decode row's top, or short of it by no more than one bf16 ulp
        # (logits are bf16 values: lm_head rounds, as in JAX) or than the
        # spread measured there between two correct routes (decode steps
        # and one forward over the sequence). A wrong acceptance, trim or
        # history write puts a token short by about the spread of the
        # logits themselves. Up to the first divergence the prefix is
        # greedy's, so there the gap is greedy's own.
        gaps = _replay_gaps(params, cfg, ids, px, look)
        ties = [dict(position=k, gap=g, spread=d, ulp=u)
                for k, (g, d, u) in enumerate(gaps) if g != 0]
        bad = [t for t in ties if not t["gap"] <= max(t["ulp"], t["spread"])]
        spreads = [d for _, d, _ in gaps]
        log(f"  lookahead request {i}: "
            f"{'equal to greedy' if j is None else f'first divergence from greedy at token {j}'};"
            f" all {n} tokens replayed with lookahead's own prefix: {len(ties)} not the decode "
            f"row's top logit, at (position, top less the token's logit, two routes' spread, "
            f"one bf16 ulp) {[(t['position'], t['gap'], t['spread'], t['ulp']) for t in ties]}; "
            f"two routes' spread over the {n} rows {min(spreads):.4g}..{max(spreads):.4g}")
        if bad:
            raise SystemExit(f"surfaces: lookahead's tokens of request {i} fall below the decode "
                             f"path's top logit by more than one ulp and the routes' spread at "
                             f"{bad}")
        _, n_gen, dispatches = spec.generate_speculative(params, cfg, [ids], *px,
                                                         max_new_tokens=n, lookahead=8,
                                                         poll_every=1)
        per_dispatch = (int(n_gen[0]) - 1) / dispatches
        # The prefill is greedy's: decode time is the request's less phase
        # 4's TTFT of the same request.
        tps = (n - 1) / max(total - r["ttft_ms"] / 1e3, 1e-9)
        log(f"  lookahead 8 request {i}: {dispatches} verify dispatches for {int(n_gen[0]) - 1} tokens after the first "
            f"({per_dispatch:.2f} accepted per dispatch), {n} tokens in {total * 1e3:.1f} ms, "
            f"decode {tps:.1f} tok/s (greedy {r['decode_tok_s']:.1f}), host clock")

        _reset_counters()
        t0 = time.perf_counter()
        b1 = model.generate([ids], *px, max_new_tokens=n, num_beams=4, length_penalty=1.0)
        torch.cuda.synchronize()
        beam_s = time.perf_counter() - t0
        b2 = model.generate([ids], *px, max_new_tokens=n, num_beams=4, length_penalty=1.0)
        _, plan, arrays, im, sg, dp = gen_mod._prepare_inputs(params, cfg, [ids], *px)
        w1 = gen_mod._beam_generate(params, cfg, arrays, im, sg, dp, None, max_new_tokens=n,
                                    num_beams=1, length_penalty=1.0,
                                    eos_id=cfg.text.eos_token_id,
                                    use_vcoder_emb=plan.use_vcoder_emb and cfg.use_vcoder_lm_emb,
                                    attn_impl="auto")[0].tolist()
        torch.cuda.synchronize()
        add(_dense_gate(f"beams request {i}", 3))
        beams = b1.sequences[0].tolist()
        if beams != b2.sequences[0].tolist():
            raise SystemExit(f"surfaces: two beam searches of request {i} disagree")
        if w1 != greedy:
            raise SystemExit(f"surfaces: beam search with W=1 differs from greedy on request {i}")
        log(f"  beams request {i}: W=4 twice identical ({beam_s:.2f} s each, host clock), "
            f"{sum(int(a != b) for a, b in zip(beams, greedy))}/{n} tokens off greedy's path, "
            f"W=1 equal to greedy; tokens sha1 {_digest(beams)}")

        for la, ref in ((0, greedy), (8, look)):
            want = tok.decode(ref, skip_special_tokens=True).strip()
            _reset_counters()
            t0 = time.perf_counter()
            chunks, first = [], None
            for text in gen_mod.generate_stream(params, cfg, [ids], *px, tokenizer=tok,
                                                max_new_tokens=n, temperature=0.0, lookahead=la):
                first = first or time.perf_counter() - t0
                chunks.append(text)
            torch.cuda.synchronize()
            add(_dense_gate(f"stream lookahead {la} request {i}", 1))
            if not chunks or chunks[-1].strip() != want:
                raise SystemExit(f"surfaces: stream (lookahead {la}) of request {i} ends in "
                                 f"{chunks[-1:]!r}, generate's text is {want!r}")
            if not all(b.startswith(a) for a, b in zip(chunks, chunks[1:])):
                raise SystemExit(f"surfaces: stream (lookahead {la}) chunks do not grow")
            log(f"  stream lookahead {la} request {i}: {len(chunks)} chunks, first after "
                f"{first * 1e3:.1f} ms, whole {(time.perf_counter() - t0) * 1e3:.1f} ms, final "
                f"text equal to generate's")
        out.append(dict(lookahead=look, ties=ties, accepted_per_dispatch=per_dispatch,
                        lookahead_tok_s=tps, greedy_tok_s=r["decode_tok_s"],
                        dispatches=dispatches))
    return dict(requests=out, counts=totals)


def _http_stream(url: str, params: dict, timeout: float = 300.0):
    """POST ``params``; returns [(seconds since the POST, payload)] per
    NUL-framed chunk, read as it arrives."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(params).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    out, buf = [], b""
    with urllib.request.urlopen(req, timeout=timeout) as r:
        while True:
            data = r.read1(65536)
            if not data:
                break
            buf += data
            while b"\0" in buf:
                chunk, buf = buf.split(b"\0", 1)
                out.append((time.perf_counter() - t0, json.loads(chunk)))
    return out


def _served_gate(label: str, chunks, first_text: str, n: int) -> list:
    """Every chunk error_code 0, ``n`` chunks, the first one's text the
    prompt plus generate's first token. Returns the served answer's words."""
    bad = [c for _, c in chunks if c.get("error_code") != 0]
    if bad or len(chunks) != n:
        raise SystemExit(f"surfaces {label}: {len(chunks)} chunks (want {n}), errors {bad[:2]}")
    if chunks[0][1]["text"] != PROMPT + first_text:
        raise SystemExit(f"surfaces {label}: first chunk {chunks[0][1]['text'][len(PROMPT):]!r}, "
                         f"generate's first token reads {first_text!r}")
    return chunks[-1][1]["text"][len(PROMPT):].split()


@contextlib.contextmanager
def _serving(httpd):
    import threading

    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        yield f"http://127.0.0.1:{httpd.server_address[1]}"
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=60)


def _dir_gib(d: str) -> float:
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d)) / 2**30


def phase_surfaces(cfg, held: list, tok, reqs, then=None) -> dict:
    """Phase 10: generate's other modes on the phase-4 weights (``held`` =
    [params, model], dropped once the checkpoint is written), then the
    serving surfaces from one checkpoint directory: the Chat-based HTTP
    worker, the engine worker at ``main()``'s defaults under 4 concurrent
    requests, and the CLI as a subprocess. ``then(dir)`` runs last, in the
    checkpoint directory (phases 11, 13 and 14). Returns the launch totals
    and the directory's GiB (``written_gib``)."""
    import base64
    import gc
    import shutil
    import threading
    import urllib.request

    import torch

    from vcoder_tpu_torch.checkpoint import save_pretrained
    from vcoder_tpu_torch.png import encode_png, unfilter_library
    from vcoder_tpu_torch.preprocess import process_images
    from vcoder_tpu_torch.serve import engine_server, server
    from vcoder_tpu_torch.serve.chat import Chat, load_image_from_base64

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  device memory at the start: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated, peak so far {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    params, model = held
    n = SURFACE_NEW
    modes = surface_modes(cfg, params, model, tok, reqs)
    totals = dict(modes["counts"])
    laps = {"modes": round(time.perf_counter() - t_phase, 1)}

    # A fourth request for the engine worker (new pictures, so its tower
    # pass is not served from the vision cache), and generate's first token
    # on each request.
    pictures = [r["pictures"] for r in reqs] + [_images(np.random.RandomState(23), 600, 800)]
    ids = reqs[0]["ids"]
    firsts = [r["greedy"][0] for r in reqs]
    px4 = [process_images([a], dtype=torch.bfloat16, device="cuda") for a in pictures[3]]
    firsts.append(int(model.generate([ids], *px4, max_new_tokens=1).sequences[0, 0]))
    first_texts = [tok.decode([t], skip_special_tokens=True) for t in firsts]
    # Every row Paeth-filtered: the filter client encoders (libpng's
    # adaptive choice) give most rows of a photo, and the decoder's slowest.
    t0 = time.perf_counter()
    unfilter_library()
    laps["png_build"] = round(time.perf_counter() - t0, 2)
    b64 = [[base64.b64encode(encode_png(a, filter_type=4)).decode() for a in p]
           for p in pictures]
    decode_ms = []
    for k, p in enumerate(pictures):
        t0 = time.perf_counter()
        got = [load_image_from_base64(x) for x in b64[k]]
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        if not all(np.array_equal(g, np.broadcast_to(a[..., None] if a.ndim == 2 else a, g.shape))
                   for g, a in zip(got, p)):
            raise SystemExit(f"surfaces: request {k}'s PNGs do not decode to their pictures")
    log(f"  PNG (Paeth rows): row-filter library built in {laps['png_build']} s; base64 decode "
        f"+ PNG decode of each request's three pictures "
        f"{', '.join(f'{m:.1f}' for m in decode_ms)} ms (host clock; inside each TTFT below)")

    def request(k):
        return {"prompt": PROMPT, "images": [b64[k][0]], "segs": [b64[k][1]],
                "depths": [b64[k][2]], "temperature": 0.0, "max_new_tokens": n, "stop": "</s>"}

    tmp = tempfile.mkdtemp(prefix="vcoder_surfaces_")
    try:
        d = os.path.join(tmp, SURFACE_DIR)
        free = shutil.disk_usage(tmp).free / 2**30
        t0 = time.perf_counter()
        save_pretrained(d, params, cfg)
        tok.save_pretrained(d)
        laps["save"] = round(time.perf_counter() - t0, 1)
        size = _dir_gib(d)
        log(f"  save_pretrained: {size:.2f} GiB in {laps['save']} s ({free:.0f} GiB free before)")
        held.clear()
        del params, model, px4
        gc.collect()
        torch.cuda.empty_cache()

        # The Chat-based server: one greedy request (the default lookahead 8).
        t0 = time.perf_counter()
        chat = Chat(d)
        laps["chat_load"] = round(time.perf_counter() - t0, 1)
        if not (chat.is_seg and chat.is_depth):
            raise SystemExit(f"surfaces: Chat did not route {SURFACE_DIR} to seg and depth")
        _reset_counters()
        with _serving(server.serve(chat, "127.0.0.1", 0)) as base:
            chunks = _http_stream(f"{base}/worker_generate_stream", request(0))
        c = _dense_gate("Chat server", 1)
        for k in totals:
            totals[k] += c[k]
        words = _served_gate("Chat server", chunks, first_texts[0], n)
        want = tok.decode(modes["requests"][0]["lookahead"]).strip()
        if " ".join(words) != want:
            raise SystemExit(f"surfaces Chat server: served {' '.join(words)!r}, "
                             f"generate(lookahead=8) reads {want!r}")
        log(f"  Chat server: loaded in {laps['chat_load']} s; {len(chunks)} chunks, error_code 0, "
            f"first after {chunks[0][0] * 1e3:.1f} ms, last after {chunks[-1][0] * 1e3:.1f} ms "
            f"(host clock); first token equal to generate's; text equal to "
            f"generate(lookahead=8)'s; served tokens sha1 {_digest(words)}")
        del chat
        gc.collect()
        torch.cuda.empty_cache()

        # The engine worker at main()'s defaults, 4 concurrent requests.
        args = engine_server.build_parser().parse_args(["--model-path", d])
        t0 = time.perf_counter()
        worker = engine_server.worker_from_args(args)
        laps["engine_load"] = round(time.perf_counter() - t0, 1)
        eng = worker.engine
        pool_gib = (eng.k_pages.numel() * eng.k_pages.element_size() * 2) / 2**30
        try:
            steps0 = len(eng.timer.samples.get("decode_step", []))
            _reset_counters()
            results = [None] * 4
            with _serving(engine_server.serve(worker, "127.0.0.1", 0)) as base:
                def client(k):
                    results[k] = _http_stream(f"{base}/worker_generate_stream", request(k))

                t0 = time.perf_counter()
                threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                wall = time.perf_counter() - t0
                if any(t.is_alive() for t in threads) or None in results:
                    raise SystemExit("surfaces: an engine worker request did not finish")
                with urllib.request.urlopen(f"{base}/stats", timeout=60) as st:
                    stats = json.loads(st.read())
            steps = len(eng.timer.samples.get("decode_step", [])) - steps0
            c = _counters()
        finally:
            worker.shutdown()
            eng.close()
        if (c["flash"] != 32 * 4 or c["vit"] != 23 * 4 or c["k8"] != 32 * steps
                or c["paged"] != c["k8"]):
            raise SystemExit(f"surfaces engine worker: launches {c} over 4 admissions and "
                             f"{steps} decode steps, want 32 flash and 23 ViT per admission "
                             f"and 32 K8 per step")
        for k in totals:
            totals[k] += c[k]
        served = [_served_gate(f"engine worker request {k}", results[k], first_texts[k], n)
                  for k in range(4)]
        ttfts = [r[0][0] * 1e3 for r in results]
        log(f"  engine worker (page {args.page_size}, max_len {args.max_len}, max_batch "
            f"{args.max_batch}, bf16 pools {pool_gib:.2f} GiB): loaded and warmed in "
            f"{laps['engine_load']} s; 4 concurrent requests x {n} tokens in {wall:.2f} s, "
            f"{4 * n / wall:.1f} tok/s aggregate (host clock, prefill included); TTFT "
            f"{', '.join(f'{t:.1f}' for t in ttfts)} ms; {steps} decode steps, launches "
            f"{json.dumps(c)}; decode step timer {json.dumps(stats['timers'].get('decode_step'))}; "
            f"every chunk error_code 0, first tokens equal to generate's; served tokens sha1 "
            f"{_digest(served)}")
        del worker, eng
        gc.collect()
        torch.cuda.empty_cache()

        # The CLI as a program: two turns on stdin, request 0's pictures.
        files = []
        for name, a in zip(("image", "seg", "depth"), pictures[0]):
            files.append(os.path.join(tmp, f"{name}.png"))
            with open(files[-1], "wb") as f:
                f.write(encode_png(a, filter_type=4))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "vcoder_tpu_torch.serve.cli", "--model-path", d,
             "--image-file", files[0], "--seg-file", files[1], "--depth-file", files[2],
             "--temperature", "0", "--max-new-tokens", str(n)],
            input=CLI_TURNS, capture_output=True, text=True, timeout=600,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        )
        laps["cli"] = round(time.perf_counter() - t0, 1)
        answers = [line.split("ASSISTANT: ", 1)[1] for line in proc.stdout.splitlines()
                   if "ASSISTANT: " in line]
        if proc.returncode != 0 or len(answers) != 2 or "exit..." not in proc.stdout:
            raise SystemExit(f"surfaces CLI: exit {proc.returncode}, {len(answers)} answers\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
        if not answers[0].startswith(first_texts[0]):
            raise SystemExit(f"surfaces CLI: first answer {answers[0][:40]!r} does not start "
                             f"with generate's first token {first_texts[0]!r}")
        log(f"  CLI: two turns in {laps['cli']} s (a subprocess: start, load, preprocess, two "
            f"streamed answers of {n} tokens); first token equal to generate's; answers sha1 "
            f"{_digest(answers)}")
        laps["phase"] = round(time.perf_counter() - t_phase, 1)
        if then is not None:
            log("COST depth eval (phase 11): cost_loader on the phase-10 checkpoint directory")
            then(d)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 10 seconds: {json.dumps(laps)}; device memory peak in the phase "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return dict(totals, written_gib=size)


# Phase 11: a COST depth eval (scripts/v1_5/eval/cost_depth.sh's flow) of the
# DS model. The tree is built from the repo's pictures, read as data.
EX = "vcoder_tpu/serve/examples"
COST_PHOTOS = ("examples/demo.jpg", f"{EX}/corgi.jpg", f"{EX}/friends.jpg", f"{EX}/people.jpg",
               f"{EX}/suits.jpg", f"{EX}/depth.jpeg")
COST_SEGS = ("examples/demo_pan.png", f"{EX}/corgi_pan.png", f"{EX}/depth_pan.png",
             f"{EX}/friends_pan.png", f"{EX}/people_pan.png", f"{EX}/suits_pan.png")
COST_DEPTHS = ("examples/demo_depth.png", f"{EX}/depth_depth.png", f"{EX}/suits_depth.jpeg")
# Every JPEG of the tree: decoded on the card and held to PIL's decode here
# (channel means and a 16x16 box-averaged thumbnail, ``JPEG_REFS``, written
# by scripts/jpeg_refs.py).
JPEG_FILES = COST_PHOTOS + (f"{EX}/suits_depth.jpeg",)
JPEG_REFS = "vcoder_tpu_torch/data/jpeg_refs.json"
JPEG_MEAN_TOL = 1.0  # uint8 levels, per channel mean
JPEG_THUMB_TOL = 4.0  # uint8 levels, per box of the 16x16 thumbnail
COST_KEYS = [f"c{i}.jpg" for i in range(8)]
COST_ORDERS = ["person, car, tree, building, sky", "dog, grass, wall", "person, person-2, table, "
               "window", "bench, tree, road, sky", "person, wall", "car, car-2, road, building, "
               "sky", "window, wall, person", "tree, grass, sky"]
COST_BATCH = 8
COST_NEW = 512  # the loader's max_new_tokens


def _sync(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def box_thumbnail(rgb: np.ndarray, n: int = 16) -> np.ndarray:
    """[H, W, 3] uint8 -> [n, n, 3] float64: the mean of each of n x n boxes
    (box edges at floor(i * H / n), floor(j * W / n))."""
    h, w = rgb.shape[:2]
    ys, xs = np.arange(n + 1) * h // n, np.arange(n + 1) * w // n
    x = rgb.astype(np.float64)
    return np.array([[x[ys[i]:ys[i + 1], xs[j]:xs[j + 1]].mean(axis=(0, 1)) for j in range(n)]
                     for i in range(n)])


def jpeg_ref(rgb: np.ndarray) -> dict:
    """The reference record of one decoded JPEG."""
    return {"shape": list(rgb.shape), "mean": rgb.reshape(-1, 3).mean(axis=0).round(4).tolist(),
            "thumb16": box_thumbnail(rgb).round(3).tolist()}


def make_cost_tree(root: str) -> dict:
    """A COST-like tree of ``COST_KEYS``: ``val2017/`` the photos,
    ``panoptic_inference/`` the panoptic maps, ``depth/`` the depth maps
    (each cycled, named like its key as COST names them) and the ground
    truth ``panoptic_order.txt`` in ``depth_accuracy``'s format."""
    here = os.path.dirname(os.path.abspath(__file__))
    tree = {"root": root, "gt": os.path.join(root, "panoptic_order.txt")}
    for sub, files in (("val2017", COST_PHOTOS), ("panoptic_inference", COST_SEGS),
                       ("depth", COST_DEPTHS)):
        os.makedirs(os.path.join(root, sub))
        tree[sub] = []
        for i, key in enumerate(COST_KEYS):
            with open(os.path.join(here, files[i % len(files)]), "rb") as f:
                data = f.read()
            tree[sub].append(os.path.join(root, sub, key))
            with open(tree[sub][-1], "wb") as f:
                f.write(data)
    with open(tree["gt"], "w") as f:
        for key, order in zip(COST_KEYS, COST_ORDERS):
            f.write(f"<IMG>{key}<IMG>The depth order for the objects present in the image "
                    f"is: {order}\n")
    return tree


def check_jpeg_decode() -> dict:
    """The JPEG files decoded by the native library (this machine's route)
    against PIL's decode, recorded in ``JPEG_REFS``: equal shapes, channel
    means within ``JPEG_MEAN_TOL`` and thumbnail boxes within
    ``JPEG_THUMB_TOL``."""
    from vcoder_tpu_torch import native_io

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, JPEG_REFS)) as f:
        refs = json.load(f)
    t0 = time.perf_counter()
    route = native_io.route()
    build_s = time.perf_counter() - t0
    worst = {"mean": 0.0, "thumb": 0.0}
    for name in JPEG_FILES:
        with open(os.path.join(here, name), "rb") as f:
            data = f.read()
        t0 = time.perf_counter()
        rgb = native_io.decode_image(data)
        ms = (time.perf_counter() - t0) * 1e3
        ref = refs[name]
        if rgb is None or list(rgb.shape) != ref["shape"]:
            raise SystemExit(f"cost eval: {name} decodes to "
                             f"{None if rgb is None else rgb.shape}, want {ref['shape']}")
        got = jpeg_ref(rgb)
        dm = float(np.abs(np.array(got["mean"]) - ref["mean"]).max())
        dt = float(np.abs(np.array(got["thumb16"]) - ref["thumb16"]).max())
        worst = {"mean": max(worst["mean"], dm), "thumb": max(worst["thumb"], dt)}
        log(f"  {name}: {rgb.shape[1]}x{rgb.shape[0]} decoded in {ms:.1f} ms; against PIL: "
            f"channel means within {dm:.4f}, thumbnail boxes within {dt:.3f} levels")
        if dm > JPEG_MEAN_TOL or dt > JPEG_THUMB_TOL:
            raise SystemExit(f"cost eval: {name} on the {route} route is {dm:.4f} / {dt:.3f} "
                             f"levels from PIL's decode (gates {JPEG_MEAN_TOL} / "
                             f"{JPEG_THUMB_TOL})")
    return {"route": route, "build_s": round(build_s, 2), **worst}


def _cost_rows(tok) -> tuple:
    """The loader's prompt ids and questions for ``COST_KEYS`` (sorted), as
    ``cost_loader.eval_model`` builds them for ``--tasks depth --use-seg
    --use-depth --conv-mode vicuna_v1 --seed 0``."""
    import random

    from vcoder_tpu_torch.conversation import conv_templates
    from vcoder_tpu_torch.mm_tokens import tokenizer_depth_seg_token
    from vcoder_tpu_torch.questions import QUESTIONS
    from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer

    # As the loader reads it back from the checkpoint: frozen, unknown words
    # to <unk> (the tokenizer in memory would grow its vocabulary).
    tok = SimpleTokenizer(vocab=tok.vocab, add_bos=tok.add_bos)
    rng = random.Random(0)
    rows, quests = [], []
    for _ in COST_KEYS:
        ques = rng.choice(QUESTIONS["depth"])
        conv = conv_templates["vicuna_v1"].copy()
        conv.append_message(conv.roles[0], "<depth>\n<seg>\n<image>\n" + ques)
        conv.append_message(conv.roles[1], None)
        rows.append(list(tokenizer_depth_seg_token(conv.get_prompt(), tok)))
        quests.append(ques)
    return rows, quests


def cost_eval_prepare(cfg, held: list, tok, device: str = "cuda") -> dict:
    """Phase 11 (a), on the held phase-4 weights: the COST tree, the JPEG
    decode against PIL's, the 24 files through ``load_images_preprocessed``
    (the PNGs against ``png.decode_png`` + ``process_images``, the tolerance
    of the JAX package's test of its two routes), and each row's first token
    and top-two logit gap from a B=1 prefill."""
    import math

    import torch

    from vcoder_tpu_torch import generation as gen_mod
    from vcoder_tpu_torch import png
    from vcoder_tpu_torch import preprocess as pp

    t_phase = time.perf_counter()
    params, model = held
    tree = make_cost_tree(tempfile.mkdtemp(prefix="vcoder_cost_"))
    jpeg = check_jpeg_decode()
    for k in pp.file_routes:
        pp.file_routes[k] = 0
    t0 = time.perf_counter()
    size = cfg.vision.image_size
    px = [pp.load_images_preprocessed(tree[sub], size=size, device=device)
          for sub in ("val2017", "panoptic_inference", "depth")]
    _sync(device)
    load_ms = (time.perf_counter() - t0) * 1e3
    routes = dict(pp.file_routes)
    if routes["PIL"] or sum(routes.values()) != 3 * len(COST_KEYS):
        raise SystemExit(f"cost eval: file routes {routes}, want every file native or png.py")
    log(f"  decode route {jpeg['route']} (library built in {jpeg['build_s']} s); JPEG against "
        f"PIL: means within {jpeg['mean']:.4f}, thumbnails within {jpeg['thumb']:.3f} levels; "
        f"24 files through load_images_preprocessed in {load_ms:.1f} ms (host clock), routes "
        f"{json.dumps(routes)}")
    got, ref, names = [], [], []
    for sub, t in (("panoptic_inference", px[1]), ("depth", px[2])):
        for k, path in enumerate(tree[sub]):
            with open(path, "rb") as f:
                data = f.read()
            if data.startswith(png.SIGNATURE):
                got.append(t[k])
                ref.append(pp.process_images([png.decode_png(data)], size=size, device=device)[0])
                names.append(f"{sub}/{COST_KEYS[k]}")
    diff = (torch.stack(got) - torch.stack(ref)).abs().float()
    mean, p99 = diff.mean().item(), torch.quantile(diff.flatten()[::7], 0.99).item()
    log(f"  {len(names)} PNG files against png.decode_png + process_images: mean "
        f"{mean:.5f}, p99 {p99:.5f}, max {diff.max().item():.4f} (normalized units)")
    if not (mean < 0.01 and p99 < 0.06):
        raise SystemExit(f"cost eval: PNG pixels off the plain route (mean {mean}, p99 {p99})")

    rows, quests = _cost_rows(tok)
    n_mod = 3
    pad_to = -(-(max(len(r) for r in rows) + n_mod * cfg.vision.num_patches) // 256) * 256
    firsts, gaps, ulps = [], [], []
    with torch.no_grad():
        for k, ids in enumerate(rows):
            one = [t[k:k + 1] for t in px]
            _, plan, arrays, im, sg, dp = gen_mod._prepare_inputs(params, cfg, [ids], *one,
                                                                  pad_to=pad_to)
            logits, _ = gen_mod._prefill(params, cfg, arrays, im, sg, dp, cache_len=plan.seq_len,
                                         use_vcoder_emb=plan.use_vcoder_emb
                                         and cfg.use_vcoder_lm_emb, attn_impl="auto")
            top2 = torch.topk(logits[0].float(), 2).values.tolist()
            first = int(model.generate([ids], *one, max_new_tokens=1, pad_to=pad_to)
                        .sequences[0, 0])
            if logits[0, first].float().item() != top2[0]:
                raise SystemExit(f"cost eval: row {k}: generate's first token {first} is not "
                                 f"the B=1 prefill's top logit")
            firsts.append(first)
            gaps.append(top2[0] - top2[1])
            ulps.append(2.0 ** (math.floor(math.log2(abs(top2[0]))) - 7))
    log(f"  B=1 first tokens {firsts} (pad_to {pad_to}); top-two gaps "
        f"{', '.join(f'{g:.4f}' for g in gaps)}")
    return dict(tree=tree, rows=rows, quests=quests, firsts=firsts, gaps=gaps, ulps=ulps,
                pad_to=pad_to, jpeg=jpeg, load_ms=load_ms,
                seconds=time.perf_counter() - t_phase)


def phase_cost_eval(ckpt: str, prep: dict, tok, device: str = "cuda") -> dict:
    """Phase 11 (b): ``cost_loader.eval_model`` on the checkpoint directory,
    as scripts/v1_5/eval/cost_depth.sh runs it (``--tasks depth --use-seg
    --use-depth --batch-size 8``, greedy, one load), then ``depth_accuracy``
    on its answers file. Gates: 8 records for the 8 keys in order and in
    the record format, each answer starting with its B=1 first token (or a
    B=1 near-tie, logged), 32 flash launches per batched prefill and 23 ViT
    blocks per tower pass and no paged launch, one finite DS >= 0 per key.
    Returns the launch counts."""
    import re
    import shutil

    from vcoder_tpu_torch import builder
    from vcoder_tpu_torch.eval import cost_loader, depth_accuracy

    t_phase = time.perf_counter()
    tree = prep["tree"]
    out_dir = os.path.join(tree["root"], "eval")
    try:
        args = cost_loader.build_parser().parse_args([
            "--model-path", ckpt, "--image-folder", os.path.join(tree["root"], "val2017"),
            "--use_seg", "--seg-image-folder", os.path.join(tree["root"], "panoptic_inference"),
            "--use_depth", "--depth-image-folder", os.path.join(tree["root"], "depth"),
            "--output-file", os.path.join(out_dir, "output"), "--tasks", "depth",
            "--temperature", "0", "--conv-mode", "vicuna_v1", "--batch-size", str(COST_BATCH),
            "--device", device,
        ])
        timing = {"load": [], "generate": []}
        load_orig, gen_orig = cost_loader.load_pretrained_model, builder.VCoderForCausalLM.generate

        def timed_load(*a, **kw):
            t0 = time.perf_counter()
            out = load_orig(*a, **kw)
            _sync(device)
            timing["load"].append(time.perf_counter() - t0)
            return out

        def timed_generate(self, *a, **kw):
            _sync(device)
            t0 = time.perf_counter()
            res = gen_orig(self, *a, **kw)
            _sync(device)
            timing["generate"].append((time.perf_counter() - t0, int(res.num_generated.sum()),
                                       tuple(res.sequences.shape)))
            return res

        cost_loader.load_pretrained_model = timed_load
        builder.VCoderForCausalLM.generate = timed_generate
        _reset_counters()
        try:
            t0 = time.perf_counter()
            answers = cost_loader.eval_model(args, "depth")
            wall = time.perf_counter() - t0
        finally:
            cost_loader.load_pretrained_model = load_orig
            builder.VCoderForCausalLM.generate = gen_orig
        c = _counters()
        batches = -(-len(COST_KEYS) // COST_BATCH)
        if c["flash"] != 32 * batches or c["vit"] != 23 * batches or c["paged"]:
            raise SystemExit(f"cost eval: launches {c} over {batches} batched prefills, want 32 "
                             f"flash and 23 ViT each and no paged launch")
        with open(answers) as f:
            text = f.read()
        records = re.findall(r"Image: ([^\n]*)\n<<QUESTION>>: ([^\n]*)\n<<ANSWER>>: (.*?)\n"
                             r"-{55}\n", text, re.S)
        rebuilt = "".join(f"Image: {k}\n<<QUESTION>>: {q}\n<<ANSWER>>: {a}\n{'-' * 55}\n"
                          for k, q, a in records)
        if ([r[0] for r in records] != COST_KEYS or [r[1] for r in records] != prep["quests"]
                or rebuilt != text):
            raise SystemExit(f"cost eval: {answers} holds {len(records)} records for keys "
                             f"{[r[0] for r in records]}, want {COST_KEYS} with the loader's "
                             f"questions, in the record format")
        ties = []
        for k, (key, _, ans) in enumerate(records):
            want = tok.decode([prep["firsts"][k]], skip_special_tokens=True)
            if not ans.startswith(want):
                if prep["gaps"][k] > prep["ulps"][k]:
                    raise SystemExit(f"cost eval: {key}'s answer {ans[:40]!r} does not start with "
                                     f"its B=1 first token {want!r} (top-two gap "
                                     f"{prep['gaps'][k]:.4f} > one ulp {prep['ulps'][k]})")
                ties.append((key, prep["gaps"][k]))
        try:
            scores = depth_accuracy.calculate_depth_score(tree["gt"], answers)
        except AssertionError as e:
            raise SystemExit(f"cost eval: depth_accuracy refuses {answers}: {e}")
        if len(scores) != len(COST_KEYS) or not all(np.isfinite(x) and x >= 0 for x in scores):
            raise SystemExit(f"cost eval: depth_accuracy gives {scores}, want one finite score "
                             f">= 0 for each of {len(COST_KEYS)} keys")
        gen_s = sum(t for t, _, _ in timing["generate"])
        n_tok = sum(n for _, n, _ in timing["generate"])
        steps = sum(shape[1] for _, _, shape in timing["generate"])
        with open(answers, "rb") as f:
            sha = hashlib.sha1(f.read()).hexdigest()[:16]
        log(f"  cost_loader.eval_model (depth, B={COST_BATCH}): load {timing['load'][0]:.1f} s, "
            f"eval wall {wall:.1f} s (host clock), generate {gen_s:.2f} s for {n_tok} tokens "
            f"({n_tok / gen_s:.1f} tok/s, {gen_s / steps * 1e3:.2f} ms a step over {steps} "
            f"steps, the batched prefill included), launches {json.dumps(c)}")
        log(f"  answers: 8 records in the record format, first tokens equal to B=1's"
            f"{'' if not ties else f' but near-ties {ties}'}; sha1 {sha}; DS per key "
            f"{', '.join(f'{x:.2f}' for x in scores)}, mean {sum(scores) / len(scores):.2f} "
            f"(random weights: each ground-truth object missing from an answer counts 100)")
        log(f"  phase 11 seconds: {json.dumps({'prepare': round(prep['seconds'], 1), 'eval': round(time.perf_counter() - t_phase, 1)})}")
        return {"flash": c["flash"], "vit": c["vit"]}
    finally:
        shutil.rmtree(tree["root"], ignore_errors=True)


# Phase 12: the slot engine (a dense KV cache per slot) at full width.
# S2's prefill logits against S1's, relative L2 per request: int8 K/V
# (per-vector absmax scales) under the prefill's flash route over the
# dequantized layer.
SLOT_PREFILL_REL_L2 = 0.1
SLOT_ENGINES = (("S1 (bf16 cache)", {}),
                ("S2 (int8 cache)", {"kv_quant": True}),
                ("S3 (bf16 cache, speculative 4, sync_every 4)",
                 {"speculative": 4, "sync_every": 4}))


def _slot_gate(label: str, c: dict, n: int, quantized_weights: bool) -> None:
    """A slot engine's launches over ``n`` admissions: 32 K1 each, 23 K2
    each on a bf16 tower (0 on a quantized one), 362 scaled K10 each with
    int8 weights (the W8A8 prefill), and nothing else: no paged kernel (the
    dense cache decodes and verifies on the plain attention route), no K5,
    no backward."""
    want = dict(flash=32 * n, flash_bwd=0, vit=0 if quantized_weights else 23 * n, mlp=0,
                k8=0, paged=0, int4=0, int8=0,
                int8_scaled=362 * n if quantized_weights else 0)
    if c != want:
        raise SystemExit(f"slot engine {label}: launches {c} over {n} admissions, want {want}")


def _run_slot(label, cfg, params, preps, *, max_new, device="cuda", **kw):
    """Build a slot engine (``ServingEngine``, max_batch 8, max_len 2048,
    EOS off) and serve ``preps`` through ``EngineWorker.from_engine``, all
    submitted at once, the counters set to 0 just before and read just
    after; each admission's prefill logits are kept. Returns (results,
    stats)."""
    import torch

    from vcoder_tpu_torch.serve.engine import ServingEngine
    from vcoder_tpu_torch.serve.engine_server import EngineWorker

    eng = ServingEngine(cfg, params, max_batch=8, max_len=2048, eos_id=-1, device=device, **kw)
    c = eng.cache
    cache_bytes = sum(t.numel() * t.element_size() for t in (c.k, c.v, c.k_scale, c.v_scale)
                      if t is not None)
    scale_bytes = sum(t.numel() * t.element_size() for t in (c.k_scale, c.v_scale)
                      if t is not None)
    prefill_logits = {}
    sample_first = eng._sample_first

    def keep(logits, req):
        prefill_logits[req.request_id] = logits.float().cpu()
        return sample_first(logits, req)

    eng._sample_first = keep
    worker = EngineWorker.from_engine(eng, model_name="vcoder_ds_llava-7b", eos_id=-1)
    try:
        _reset_counters()
        res, wall = _drive(worker, preps)
        _sync(device)
        counts = _counters()
    finally:
        worker.shutdown()
        eng.close()
        if device == "cuda":
            torch.cuda.empty_cache()
    bad = [r for r in res if r["err"] is not None or len(r["tokens"]) != max_new]
    if bad:
        raise SystemExit(f"slot engine {label}: requests did not complete: {bad[:2]}")
    steps = eng.timer.samples.get("decode_step", [])
    n_tok = sum(len(r["tokens"]) - 1 for r in res)
    st = dict(counts=counts, ttft_p50_ms=float(np.median([r["ttft_s"] for r in res])) * 1e3,
              decode_tok_s=n_tok / sum(steps), step_p50_ms=float(np.median(steps)) * 1e3,
              steps=len(steps), wall_s=wall, cache_gb=cache_bytes / 1e9,
              scale_gb=scale_bytes / 1e9,
              logits=[prefill_logits[i] for i in sorted(prefill_logits)],
              digest=_digest([r["tokens"] for r in res]))
    log(f"  slot engine {label}: {len(res)} requests x {max_new} tokens in {wall:.2f} s; TTFT "
        f"p50 {st['ttft_p50_ms']:.1f} ms; aggregate decode {st['decode_tok_s']:.1f} tok/s "
        f"({n_tok} tokens after the first over {sum(steps):.2f} s of decode steps); step wall "
        f"p50 {st['step_p50_ms']:.2f} ms over {len(steps)} steps; cache {st['cache_gb']:.2f} GB "
        f"({st['scale_gb'] * 1e3:.1f} MB of it scales); launches {json.dumps(counts)}; tokens "
        f"sha1 {st['digest']}")
    return res, st


def _replay_gate(label, params, cfg, preps, res, pixels) -> list:
    """Every token of each row, replayed on ``generate``'s decode path with
    the row's own prefix (phase 10's rule): the decode row's top logit, or
    short of it by no more than one bf16 ulp or the two routes' spread
    there. Returns the near-ties (request, position, gap, spread, ulp)."""
    ties = []
    for i, (prep, r) in enumerate(zip(preps, res)):
        gaps = _replay_gaps(params, cfg, list(prep.input_ids), pixels[i], r["tokens"])
        for j, (g, d, u) in enumerate(gaps):
            if g == 0:
                continue
            ties.append((i, j, g, d, u))
            if not g <= max(u, d):
                raise SystemExit(f"slot engine {label}: request {i}'s token {j} falls below the "
                                 f"decode path's top logit by {g} (one ulp {u}, the routes' "
                                 f"spread {d})")
    return ties


def phase_slot_engine(cfg, params, model, preps, device="cuda", quantized=True) -> dict:
    """Phase 12: the slot engine at full width, engine A's traffic (``preps``:
    8 requests of 32 tokens, EOS off) through ``EngineWorker.from_engine``.
    S1: a bf16 dense cache; S2: an int8 cache (``kv_quant``); S3: S1 with
    ``speculative=4, sync_every=4`` (the fused speculative windows); S4
    (``quantized``): the weights quantized to int8 on the card with an int8
    cache (bench.py's ``sec_serve_int8_b8``). Gates: launches per admission
    (:func:`_slot_gate`); every S1 and S3 token on ``generate``'s decode
    path under phase 10's replay rule (so S1's first tokens are the B=1
    prefill's and its tokens ``generate``'s up to a near-tie, and S3's are
    S1's likewise); S2's prefill logits within ``SLOT_PREFILL_REL_L2`` of
    S1's. Returns the launch totals."""
    import torch

    t_phase = time.perf_counter()
    max_new = preps[0].max_new_tokens
    dtype = params["lm"]["embed_tokens"].dtype
    pixels = [[torch.as_tensor(x).to(device, dtype) for x in (p.images, p.segs, p.depths)]
              for p in preps]
    n = len(preps)
    runs = {}
    for label, kw in SLOT_ENGINES:
        res, st = _run_slot(label, cfg, params, preps, max_new=max_new, device=device, **kw)
        _slot_gate(label, st["counts"], n, False)
        runs[label[:2]] = (res, st)
    (r1, s1), (r2, s2), (r3, s3) = runs["S1"], runs["S2"], runs["S3"]

    greedy = [model.generate([list(p.input_ids)], *px, max_new_tokens=max_new).sequences[0]
              .tolist() for p, px in zip(preps, pixels)]
    _sync(device)
    first_eq = sum(int(g[0] == r["tokens"][0]) for g, r in zip(greedy, r1))
    diverge = [next((j for j in range(max_new) if g[j] != r["tokens"][j]), None)
               for g, r in zip(greedy, r1)]
    ties1 = _replay_gate("S1", params, cfg, preps, r1, pixels)
    ties3 = _replay_gate("S3", params, cfg, preps, r3, pixels)
    s3_eq = sum(int(a == b) for x, y in zip(r1, r3) for a, b in zip(x["tokens"], y["tokens"]))
    log(f"  S1 vs generate (B=1, prompt padded to generate's length, not the engine's bucket): "
        f"first tokens {first_eq}/{n} equal; first divergence per request {diverge}; every S1 "
        f"token replayed on the decode path: {len(ties1)} not the top logit, at (request, "
        f"position, gap, spread, ulp) {ties1}")
    log(f"  S3 vs S1: {s3_eq}/{n * max_new} tokens equal; every S3 token replayed: {len(ties3)} "
        f"not the top logit, at {ties3}")

    rels = [((b - a).norm() / a.norm()).item() for a, b in zip(s1["logits"], s2["logits"])]
    s2_eq = sum(int(a == b) for x, y in zip(r1, r2) for a, b in zip(x["tokens"], y["tokens"]))
    s2_first = sum(int(x["tokens"][0] == y["tokens"][0]) for x, y in zip(r1, r2))
    ok = max(rels) <= SLOT_PREFILL_REL_L2 and all(np.isfinite(rels))
    log(f"  S2 vs S1: prefill logits rel L2 per request {[round(x, 5) for x in rels]} (bound "
        f"{SLOT_PREFILL_REL_L2}) -> {'ok' if ok else 'FAIL'}; first tokens {s2_first}/{n} "
        f"equal; {s2_eq}/{n * max_new} tokens equal to S1's")
    if not ok:
        raise SystemExit("slot engine S2: the int8 cache's prefill logits stray from S1's")

    totals = {k: 0 for k in ("flash", "vit", "int8_scaled")}
    for _, st in runs.values():
        for k in totals:
            totals[k] += st["counts"][k]
    stats = {k: {m: st[m] for m in ("ttft_p50_ms", "decode_tok_s", "step_p50_ms", "cache_gb")}
             for k, (_, st) in runs.items()}
    if quantized:
        from vcoder_tpu_torch.quant import quantize_params

        q8 = quantize_params(params, bits=8, destroy=False)
        label = "S4 (int8 weights, int8 cache)"
        r4, s4 = _run_slot(label, cfg, q8, preps, max_new=max_new, device=device,
                           kv_quant=True)
        _slot_gate(label, s4["counts"], n, True)
        del q8
        if device == "cuda":
            torch.cuda.empty_cache()
        s4_eq = sum(int(a == b) for x, y in zip(r2, r4) for a, b in zip(x["tokens"], y["tokens"]))
        log(f"  S4 vs S2: {s4_eq}/{n * max_new} tokens equal (a reading: int8 weights)")
        for k in totals:
            totals[k] += s4["counts"][k]
        stats["S4"] = {m: s4[m] for m in ("ttft_p50_ms", "decode_tok_s", "step_p50_ms",
                                          "cache_gb")}
    log(f"  phase 12: {time.perf_counter() - t_phase:.1f} s; "
        f"{json.dumps({k: {m: round(v, 2) for m, v in s.items()} for k, s in stats.items()})}")
    return totals


# The card machine's disk takes ~45 GiB of writes a run, deleted files
# included, and phase 10's checkpoint directory already writes 13.5 GiB: the
# training stages' weight files (a 13B step checkpoint is 79 GB) go into
# pipes, in-process sinks that keep the header and count the bytes.
PIPED_WEIGHTS = ("checkpoint-{steps}/state.safetensors.tmp", "adapters.safetensors",
                 "final/model.safetensors")


class _WeightPipe:
    """A weight file's stand-in for its writer: ``write`` keeps the first
    64 MiB (the safetensors header and then some) and counts the bytes; the
    data goes nowhere. On close it files {"header", "header_len", "bytes",
    "s"} (``s``: from the writer's open to its close) under its name."""

    def __init__(self, name: str, results: dict):
        self.name, self.results = name, results
        self.head, self.n, self.t0 = bytearray(), 0, time.perf_counter()

    def write(self, b) -> int:
        mv = memoryview(b).cast("B")
        room = (64 << 20) - len(self.head)
        if room > 0:
            self.head += mv[:room]
        self.n += mv.nbytes
        return mv.nbytes

    def close(self) -> None:
        header, k = None, 0
        if len(self.head) >= 8:
            (k,) = struct.unpack("<Q", bytes(self.head[:8]))
            if len(self.head) >= 8 + k:
                try:
                    header = json.loads(bytes(self.head[8:8 + k]))
                except ValueError:
                    pass
        self.results[self.name] = dict(header=header, header_len=k, bytes=self.n,
                                       s=time.perf_counter() - self.t0)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()


@contextlib.contextmanager
def piped_weights(out: str, steps: int):
    """Each of a stage's weight files under ``out`` (``PIPED_WEIGHTS``)
    written into a :class:`_WeightPipe` instead of the disk: the port's
    ``checkpoint.write_safetensors`` opens it through that module's
    ``open``, and an empty file stands at its path, so the stage's renames
    and existence checks find it as they would the file. Yields {name:
    {"header", "header_len", "bytes", "s"}}, filled as each writer closes;
    a file no writer opened is missing from it."""
    from vcoder_tpu_torch import checkpoint

    names = {os.path.abspath(os.path.join(out, n.format(steps=steps))): n.format(steps=steps)
             for n in PIPED_WEIGHTS}
    results = {}

    def pipe_open(path, mode="r", *a, **kw):
        name = names.get(os.path.abspath(path))
        if name is None or "w" not in mode:
            return open(path, mode, *a, **kw)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "wb").close()
        return _WeightPipe(name, results)

    checkpoint.open = pipe_open
    try:
        yield results
    finally:
        del checkpoint.open


def piped_gate(label: str, got: dict, keys: dict) -> dict:
    """Each piped file's header names ``keys[name]`` (a set of tensor names
    it must hold) and the bytes received are the header's and its data's.
    Returns {name: GiB}."""
    bad, sizes = [], {}
    for name, want in keys.items():
        r = got.get(name) or {}
        h = r.get("header")
        if h is None:
            bad.append(f"{name}: no safetensors header arrived")
            continue
        end = max((m["data_offsets"][1] for k, m in h.items() if k != "__metadata__"),
                  default=0)
        if r["bytes"] != 8 + r["header_len"] + end:
            bad.append(f"{name}: {r['bytes']} bytes, the header says "
                       f"{8 + r['header_len'] + end}")
        if not want <= set(h):
            bad.append(f"{name}: {len(want - set(h))} tensors missing, e.g. "
                       f"{sorted(want - set(h))[:2]}")
        sizes[name] = round(r["bytes"] / 2**30, 2)
    if bad:
        raise SystemExit(f"{label}: " + "; ".join(bad))
    return sizes


# Phase 13: a training stage from files. COST's training layout
# (tests/test_train_pipeline.py::_make_cost_tree's) on the repo's pictures.
TRAIN_BUCKETS = ("train", "unlabeled", "test")
TRAIN_STEPS = 4


def make_train_tree(root: str) -> None:
    """COST's training tree of ``COST_KEYS`` in each bucket: photos under
    ``coco/<bucket>2017/``, panoptic maps under every
    ``coco_segm_text/<bucket>/<task>_inference/``, depth maps under
    ``coco_segm_text/depth/<bucket>/depth/`` (each cycled, named like its
    key), the answers in ``<task>.txt`` and the depth orders in
    ``panoptic_order.txt``, in COST's ``<IMG>key<IMG>answer`` lines."""
    here = os.path.dirname(os.path.abspath(__file__))

    def copy(files, d):
        os.makedirs(d, exist_ok=True)
        for i, key in enumerate(COST_KEYS):
            shutil.copyfile(os.path.join(here, files[i % len(files)]), os.path.join(d, key))

    def lines(path, text):
        with open(path, "w") as f:
            for key, order in zip(COST_KEYS, COST_ORDERS):
                f.write(f"<IMG>{key}<IMG>{text}{order}\n")

    for bucket in TRAIN_BUCKETS:
        segm = os.path.join(root, "coco_segm_text", bucket)
        for task in ("panoptic", "semantic", "instance"):
            copy(COST_SEGS, os.path.join(segm, f"{task}_inference"))
            lines(os.path.join(segm, f"{task}.txt"), "The objects present in the image are: ")
        ddir = os.path.join(root, "coco_segm_text", "depth", bucket)
        copy(COST_DEPTHS, os.path.join(ddir, "depth"))
        lines(os.path.join(ddir, "panoptic_order.txt"),
              "The depth order for the objects present in the image is: ")
        copy(COST_PHOTOS, os.path.join(root, "coco", f"{bucket}2017"))


@contextlib.contextmanager
def timed_train_steps(records: list, device: str = "cuda", first=None):
    """Time every step of the ``Trainer``s built inside the block: each step
    appends ``ms`` (CUDA events around the step on the card, the host clock
    on the CPU), the batch's ``T`` and valid ``tokens``, the step's ``loss``
    and ``grad_norm``, the per-leaf gradient ``norms``, and for an offloaded
    step its stager's ``copies`` (``StateStager.pop_stats``: H2D, D2H and
    update ms, the pass's wall).
    ``first(params)`` runs before the first step."""
    import torch

    from vcoder_tpu_torch.train import trainer as trainer_mod

    make_step = trainer_mod.make_train_step

    def timed_make(*a, **kw):
        inner = make_step(*a, **kw)

        def timed(p, state, batch):
            if first is not None and not records:
                first(p)
            t0 = time.perf_counter()
            if device == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
            res = inner(p, state, batch)
            if device == "cuda":
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
            else:
                ms = (time.perf_counter() - t0) * 1e3
            rec = dict(ms=ms, T=int(batch["safe_ids"].shape[1]),
                       tokens=int(batch["attn_mask"].sum()), loss=float(res[2]["loss"]),
                       grad_norm=float(res[2]["grad_norm"]),
                       norms={k: float(v) for k, v in res[2]["leaf_grad_norms"].items()})
            if inner.stager is not None:
                rec["copies"] = inner.stager.pop_stats()
            records.append(rec)
            return res

        timed.stager = inner.stager
        return timed

    trainer_mod.make_train_step = timed_make
    try:
        yield records
    finally:
        trainer_mod.make_train_step = make_step


def piped_train_keys(trainer) -> dict:
    """The tensors each piped weight file of ``trainer``'s stage must hold:
    every parameter, state entry and ``step`` in the step checkpoint, the
    trainable leaves in the adapters, the embedding and every layer's query
    weight in ``final/``."""
    from vcoder_tpu_torch.train.step import trainable_leaves
    from vcoder_tpu_torch.tree import named_leaves

    n_layers = trainer.cfg.text.num_layers
    # The state's keys from the optimizer (a LoRA driver releases the state
    # before its merge).
    state = trainer.optimizer.init({p: t.to("meta") for p, t in
                                    trainable_leaves(trainer.params, trainer.args.stage).items()})
    return {
        f"checkpoint-{trainer.step}/state.safetensors.tmp":
            {f"params/{p}" for p, _ in named_leaves(trainer.params)}
            | {f"opt/{k}" for k in state} | {"step"},
        "adapters.safetensors": set(trainable_leaves(trainer.params, trainer.args.stage)),
        "final/model.safetensors": {"model.embed_tokens.weight"}
            | {f"model.layers.{i}.self_attn.q_proj.weight" for i in range(n_layers)},
    }


@contextlib.contextmanager
def timed_loads(laps: dict, device: str = "cuda"):
    """The seconds of the ``builder.load_pretrained_model`` calls made inside
    the block, summed into ``laps["load_s"]``."""
    from vcoder_tpu_torch import builder

    load = builder.load_pretrained_model

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            res = load(*a, **kw)
            _sync(device)
            return res
        finally:
            laps["load_s"] = laps.get("load_s", 0.0) + time.perf_counter() - t0

    builder.load_pretrained_model = timed
    try:
        yield laps
    finally:
        builder.load_pretrained_model = load


def _drive_stage(main_fn, argv: list, out: str, steps: int, device: str, first=None,
                 piped: bool = True, outputs: bool = True) -> dict:
    """A stage driver's ``main(argv)`` in this process, its weight files
    through pipes (``piped``; else written as files), every step timed
    (``first`` as :func:`timed_train_steps` takes it), the counters read
    from 0 and the peak of allocated device memory from the load on.
    Returns the trainer, the steps' records, the counts, the pipes' readings
    and sizes, and with ``outputs`` (the process that writes them)
    ``metrics.jsonl`` and ``final/config.json``; the wall and the load's
    seconds."""
    import gc

    import torch

    records, laps = [], {}
    gc.collect()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _reset_counters()
    t0 = time.perf_counter()
    pipes = piped_weights(out, steps) if piped else contextlib.nullcontext({})
    with pipes as got, timed_train_steps(records, device, first), timed_loads(laps, device):
        trainer = main_fn(argv)
    _sync(device)
    res = dict(trainer=trainer, records=records, counts=_counters(), piped=got,
               wall=time.perf_counter() - t0, load_s=laps.get("load_s", float("nan")),
               peak=torch.cuda.max_memory_allocated() if cuda else float("nan"), sizes={})
    if outputs:
        with open(os.path.join(out, "metrics.jsonl")) as f:
            res["metrics"] = [json.loads(line) for line in f]
        with open(os.path.join(out, "final", "config.json")) as f:
            res["final_config"] = json.load(f)
    if piped:
        res["sizes"] = piped_gate(main_fn.__module__, got, piped_train_keys(trainer))
    return res


def phase_train_stage(ckpt: str, device: str = "cuda") -> dict:
    """Phase 13: the VCoder-DS training stage as
    ``scripts/v1_5/train_torch/vcoder_ds_train.sh`` runs it, from the
    checkpoint directory ``ckpt`` over a COST tree written by
    :func:`make_train_tree`: ``vcoder_ds_train``'s parser and ``run_stage``
    in this process (so the launch counters can be read), B=4,
    ``--model-max-length 2048``, ``--max-steps 4``, 8 loader threads; and
    the module's ``--help`` as a subprocess. Gates: 4 finite losses in
    ``metrics.jsonl``; non-zero seg-projector and ``vcoder_lm_emb``
    gradient norms on every step; per step 32 K6 calls, 64 K1 launches and
    23 ViT blocks, and no other kernel; ``adapters.safetensors``, the step
    checkpoint and ``final/`` written (the weight files through
    :func:`piped_weights`), ``final/config.json`` naming
    ``vcoder_ds_llava``. Returns the launch counts."""
    import gc

    import torch

    from vcoder_tpu_torch import native_io
    from vcoder_tpu_torch.train import vcoder_ds_train

    t_phase = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "vcoder_tpu_torch.train.vcoder_ds_train",
                           "--help"], capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0 or "--seg-data-path" not in proc.stdout:
        raise SystemExit(f"train stage: the module's --help exits {proc.returncode}\n"
                         f"{proc.stderr[-2000:]}")
    help_s = time.perf_counter() - t_phase
    tmp = tempfile.mkdtemp(prefix="vcoder_train_stage_")
    try:
        tree, out = os.path.join(tmp, "cost"), os.path.join(tmp, "out")
        make_train_tree(tree)
        argv = ["--model-path", ckpt, "--seg-data-path", tree, "--depth-data-path", tree,
                "--image-folder", tree, "--output-dir", out,
                "--per-device-train-batch-size", "4", "--model-max-length", "2048",
                "--max-steps", str(TRAIN_STEPS), "--device", device]
        res = _drive_stage(vcoder_ds_train.main, argv, out, TRAIN_STEPS, device)
        records, metrics, counts, wall, sizes = (res[k] for k in (
            "records", "metrics", "counts", "wall", "sizes"))
        peak = res["peak"] / 2**30
        trainer = res.pop("trainer")
        routes, n_entries = dict(trainer.dataset.routes), len(trainer.dataset)
        del trainer
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        final_type = res["final_config"].get("model_type")
        final_files = sorted(os.listdir(os.path.join(out, "final")))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for m, r in zip(metrics, records):
        seg = max(v for k, v in r["norms"].items() if k.startswith("seg_projector/"))
        log(f"  train stage step {m['step']}: T={r['T']} B=4, {r['tokens']} tokens, "
            f"{r['ms']:.1f} ms, {r['tokens'] / r['ms'] * 1e3:.0f} tokens/s, loss "
            f"{m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, seg projector grad norm "
            f"{seg:.4g}, vcoder_lm_emb {r['norms']['vcoder_lm_emb']:.4g}")
    bad = []
    if len(metrics) != TRAIN_STEPS or len(records) != TRAIN_STEPS or not all(
            np.isfinite([m["loss"], m["grad_norm"]]).all() for m in metrics):
        bad.append(f"{len(metrics)} metrics lines, {len(records)} steps, or a non-finite loss")
    if not all(any(v > 0 for k, v in r["norms"].items() if k.startswith("seg_projector/"))
               and r["norms"]["vcoder_lm_emb"] > 0 for r in records):
        bad.append("a zero seg_projector / vcoder_lm_emb gradient")
    want = dict(flash=64 * TRAIN_STEPS, flash_bwd=32 * TRAIN_STEPS, vit=23 * TRAIN_STEPS, mlp=0,
                k8=0, paged=0, int4=0, int8=0, int8_scaled=0)
    if counts != want:
        bad.append(f"launches {counts} != {want}")
    if final_type != "vcoder_ds_llava" or "model.safetensors" not in final_files:
        bad.append(f"final/ holds {final_files}, its config.json model_type {final_type!r}")
    if bad:
        raise SystemExit("train stage: " + "; ".join(bad))
    ms_p50 = float(np.median([r["ms"] for r in records[1:]]))
    tok_s = float(np.median([r["tokens"] / r["ms"] * 1e3 for r in records[1:]]))
    log(f"  train stage: {n_entries} entries from the COST tree; run_stage {wall:.1f} s (load, "
        f"{TRAIN_STEPS} steps, checkpoint, adapters, final/); steps 2-{TRAIN_STEPS} p50 "
        f"{ms_p50:.1f} ms, {tok_s:.0f} valid tokens/s; peak {peak:.2f} GiB allocated; files "
        f"decoded {json.dumps(routes)} (native: the library's {native_io.route()} route) by 8 "
        f"loader threads; --help subprocess {help_s:.1f} s; launches {json.dumps(counts)}; "
        f"weights written through pipes (GiB) {json.dumps(sizes)}; final/config.json "
        f"model_type {final_type}; phase {time.perf_counter() - t_phase:.1f} s")
    return dict(flash=counts["flash"], flash_bwd=counts["flash_bwd"], vit=counts["vit"],
                step_ms_p50=ms_p50, tokens_s=tok_s, peak_gib=peak)


# Phase 14: the first full-LLM stage (scripts/v1_5/train_torch/finetune.sh's
# flow) over a plain-LLaVA directory, with the Adam moments in pinned host
# memory (--offload-opt-state).
LLAVA_DIR = "llava-v1.5-7b"
FULL_STEPS = 4
FULL_BATCH = 4  # the largest of 4, 2, 1 whose offloaded step fits the card
AB_STEPS = 2
AB_BATCH = 1  # the resident step fits at this batch
AB_LR = 1e-3  # large enough that every bf16 leaf moves on the second step
LLAVA_SAMPLES = 24
LLAVA_TURNS = 6
MOMENT_CUT = 0.8  # the offloaded peak lies this many moments' bytes below the resident one


def write_llava_dir(d: str, ds_dir: str) -> None:
    """Phase 14's plain-LLaVA base beside the VCoder-DS directory ``ds_dir``:
    its config with the llava variant's flags, its tokenizer files, and its
    weights file hard-linked (no byte written). The llava config reads the
    tower, ``mm_projector`` and ``lm`` from it (``import_vcoder`` takes no
    seg, depth or ``vcoder_lm_emb`` tensor for a llava model)."""
    from vcoder_tpu_torch.config import VCoderConfig, _variant_flags

    os.makedirs(d, exist_ok=True)
    for f in os.listdir(ds_dir):
        if f == "model.safetensors":
            os.link(os.path.join(ds_dir, f), os.path.join(d, f))
        elif f == "config.json":
            with open(os.path.join(ds_dir, f)) as fh:
                cfg = VCoderConfig.from_hf_config(json.load(fh))
            with open(os.path.join(d, f), "w") as fh:
                json.dump(dataclasses.replace(cfg, model_type="llava", **_variant_flags("llava"))
                          .to_hf_config(), fh, indent=2)
        elif os.path.isfile(os.path.join(ds_dir, f)):
            shutil.copyfile(os.path.join(ds_dir, f), os.path.join(d, f))


def make_llava_json(path: str, n: int = LLAVA_SAMPLES, turns: int = LLAVA_TURNS,
                    seed: int = 0) -> None:
    """LLaVA-format samples (``image`` + ``conversations``) over the repo's
    photos, read as data (``image`` relative to the repo's root): each a
    conversation of ``turns`` turns, questions of 12 words and answers
    of 150-199 drawn from PROMPT's words (every one in the tokenizer), so a
    row's ~1,200 text tokens and 576 image tokens fill the 2048 bucket."""
    rng = np.random.RandomState(seed)
    words = sorted(set(re.findall(r"[a-zA-Z']+", PROMPT)))
    entries = []
    for i in range(n):
        conv = []
        for t in range(turns):
            q = " ".join(rng.choice(words, 12)) + "?"
            a = " ".join(rng.choice(words, rng.randint(150, 200))) + "."
            conv += [{"from": "human", "value": ("<image>\n" if t == 0 else "") + q},
                     {"from": "gpt", "value": a}]
        entries.append({"id": f"full-{i}", "image": COST_PHOTOS[i % len(COST_PHOTOS)],
                        "conversations": conv})
    with open(path, "w") as f:
        json.dump(entries, f)


def _rss_gib() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def bits_digest(tensors: dict, device: str = "cuda") -> str:
    """A digest of every bit of ``tensors`` (by name), computed on
    ``device`` a chunk at a time (a host tensor's chunk is copied there
    first): per tensor, the sum of its elements' bit patterns and their
    sum weighted by position, in wrapping int64."""
    import torch

    words = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    h = hashlib.sha1()
    for name in sorted(tensors):
        flat = tensors[name].detach().reshape(-1)
        flat = flat.view(words[flat.element_size()])
        acc = torch.zeros(2, dtype=torch.int64, device=device)
        step = 1 << 26
        for a in range(0, flat.numel(), step):
            c = flat[a:a + step].to(device).to(torch.int64)
            w = torch.arange(a, a + c.numel(), device=device) % 65521 + 1
            acc[0] += c.sum()
            acc[1] += (c * w).sum()
        h.update(f"{name}:{acc.tolist()}:{tuple(flat.shape)};".encode())
    return h.hexdigest()[:16]


def _train_gate(label: str, records: list, counts: dict, steps: int, layers: int = 32,
                vit: int = 23, launches: bool = True) -> None:
    """Phase 14's per-step gates: finite losses, non-zero gradients on the
    ``lm/`` leaves and on ``mm_projector``, and (``launches``) per step ``2
    x layers`` K1, ``layers`` K6 and ``vit`` ViT blocks (64, 32 and 23 at 7B
    on one card; the tower takes its unfused blocks under a mesh) and no
    other kernel."""
    bad = []
    if len(records) != steps:
        bad.append(f"{len(records)} steps, want {steps}")
    for i, r in enumerate(records):
        lm = max(v for k, v in r["norms"].items() if k.startswith("lm/"))
        mm = max(v for k, v in r["norms"].items() if k.startswith("mm_projector/"))
        if not (lm > 0 and mm > 0 and np.isfinite(list(r["norms"].values())).all()):
            bad.append(f"step {i + 1}: lm/ grad norm {lm}, mm_projector {mm}")
    want = dict(flash=2 * layers * steps, flash_bwd=layers * steps, vit=vit * steps, mlp=0, k8=0,
                paged=0, int4=0, int8=0, int8_scaled=0)
    if launches and counts != want:
        bad.append(f"launches {counts} != {want}")
    if bad:
        raise SystemExit(f"full stage {label}: " + "; ".join(bad))


def _copies_line(r: dict) -> str:
    c = r.get("copies")
    if not c or not c["wall"]:
        return "copies not measured"
    serial = c["h2d"] + c["d2h"] + c["update"]
    return (f"update pass {c['wall']:.1f} ms over {c['chunks']} chunks: H2D {c['h2d']:.1f}, "
            f"D2H {c['d2h']:.1f}, update {c['update']:.1f} ms, {serial - c['wall']:.1f} ms "
            f"of the {serial:.1f} overlapped")


def _locals(tensors: dict) -> dict:
    """Each tensor as this process holds it: a DTensor's local shard, a
    plain tensor as is."""
    from torch.distributed.tensor import DTensor

    return {k: t.to_local() if isinstance(t, DTensor) else t for k, t in tensors.items()}


def full_stage_ab(trainer, tmp: str, vit: int = 23, launches: bool = True) -> dict:
    """Phase 14's A/B: from the stage's trained weights, ``AB_STEPS`` steps
    of B=``AB_BATCH`` through ``Trainer`` with the moments resident, then
    from the same starting trainable leaves (restored from a host copy) the
    same steps offloaded, over the same dataset and sampler. Gates: the
    trainable leaves and the whole optimizer state bit-equal (a digest of
    every bit), the leaves moved, and the offloaded peak of allocated device
    memory at least ``MOMENT_CUT`` x the moments' bytes below the resident
    one. Over a distributed mesh (the trainer's) each rank runs this on its
    shards: the digests, the moments' bytes and the peaks are its own. The
    launch gates (:func:`_train_gate`) count the model's layers and ``vit``
    ViT blocks a step, and gate only with ``launches``."""
    import gc

    import torch

    from vcoder_tpu_torch.train.step import trainable_leaves
    from vcoder_tpu_torch.train.trainer import TrainArgs, Trainer

    cfg, params, dataset, mesh = trainer.cfg, trainer.params, trainer.dataset, trainer.mesh
    device = trainer.device
    cuda = device.type == "cuda"
    # The stage's state goes: its pinned blocks return to the host
    # allocator's cache, where the offloaded run takes them again.
    trainer.release_state()
    leaves = _locals(trainable_leaves(params, "full"))
    start = {p: t.detach().to("cpu", copy=True) for p, t in leaves.items()}
    start_digest = bits_digest(leaves, device)
    runs = {}
    for mode in ("resident", "offloaded"):
        with torch.no_grad():
            for p, t in leaves.items():
                t.copy_(start[p])
        args = TrainArgs(output_dir=os.path.join(tmp, mode), stage="full", learning_rate=AB_LR,
                         per_device_train_batch_size=AB_BATCH, save_steps=10**9,
                         offload_opt_state=mode == "offloaded")
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _reset_counters()
        records = []
        with timed_train_steps(records, device.type):
            tr = Trainer(cfg, params, dataset, args, mesh=mesh, device=device)
            hist = tr.train(max_steps=AB_STEPS)
        _sync(device)
        counts = _counters()
        peak = torch.cuda.max_memory_allocated() if cuda else float("nan")
        _train_gate(f"A/B {mode}", records, counts, AB_STEPS, cfg.text.num_layers, vit,
                    launches)
        state = _locals(tr.opt_state)
        moments = sum(t.numel() * t.element_size() for k, t in state.items()
                      if k.startswith(("mu/", "nu/")))
        runs[mode] = dict(peak=peak, records=records, counts=counts, moments=moments,
                          losses=[h["loss"] for h in hist],
                          params=bits_digest(_locals(trainable_leaves(tr.params, "full")),
                                             device),
                          state=bits_digest(state, device),
                          where=sorted({f"{t.device.type}{'/pinned' if t.is_pinned() else ''}"
                                        for t in state.values() if t.ndim}))
        del tr, state
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    res, off = runs["resident"], runs["offloaded"]
    for mode, r in runs.items():
        log(f"  A/B {mode} (B={AB_BATCH}, lr {AB_LR}): steps "
            + "; ".join(f"{x['ms']:.1f} ms T={x['T']} {x['tokens']} tokens" for x in r["records"])
            + f"; losses {', '.join(f'{v:.4f}' for v in r['losses'])}; peak "
            f"{r['peak'] / 2**30:.2f} GiB allocated; state in {r['where']}; digests params "
            f"{r['params']} state {r['state']}"
            + (f"; {_copies_line(r['records'][-1])}" if mode == "offloaded" else ""))
    bad = []
    if (res["params"], res["state"]) != (off["params"], off["state"]):
        bad.append("the offloaded step's leaves or state differ from the resident step's")
    if res["params"] == start_digest:
        bad.append("no trainable leaf moved")
    if cuda:
        cut = res["peak"] - off["peak"]
        if off["where"] != ["cpu/pinned"] or cut < MOMENT_CUT * off["moments"]:
            bad.append(f"offloaded state in {off['where']}, peak {cut / 2**30:.2f} GiB below the "
                       f"resident one, want >= {MOMENT_CUT} x {off['moments'] / 2**30:.2f} GiB")
    if bad:
        raise SystemExit("full stage A/B: " + "; ".join(bad))
    ms = {m: r["records"][-1]["ms"] for m, r in runs.items()}
    log(f"  A/B: leaves and state bit-equal (digests {off['params']}, {off['state']}); peak "
        f"{off['peak'] / 2**30:.2f} GiB offloaded against {res['peak'] / 2**30:.2f} resident "
        f"({(res['peak'] - off['peak']) / 2**30:.2f} GiB less; moments "
        f"{off['moments'] / 2**30:.2f} GiB); step {AB_STEPS} {ms['offloaded']:.1f} ms offloaded "
        f"against {ms['resident']:.1f} resident (+{ms['offloaded'] - ms['resident']:.1f} ms)")
    return dict(counts={k: res["counts"][k] + off["counts"][k] for k in res["counts"]},
                peak_resident=res["peak"], peak_offloaded=off["peak"], ms=ms,
                moments=off["moments"])


def phase_full_stage(ckpt: str, device: str = "cuda", turns: int = LLAVA_TURNS) -> dict:
    """Phase 14: the LLaVA full finetune at 7B, :func:`full_stage_cli` from
    the VCoder-DS directory ``ckpt`` at B=``FULL_BATCH``, ``FULL_STEPS``
    steps, with its gates; then :func:`full_stage_ab` on the trained
    weights. Returns the launch counts and the readings."""
    import gc

    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="vcoder_full_stage_")
    try:
        trainer, got = full_stage_cli("14", ckpt, tmp, LLAVA_DIR, FULL_BATCH, FULL_STEPS, device,
                                      turns)
        ab = full_stage_ab(trainer, tmp)
        del trainer
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 14 {time.perf_counter() - t_phase:.1f} s")
    counts = got["counts"]
    total = {k: counts[k] + ab["counts"][k] for k in counts}
    return dict(flash=total["flash"], flash_bwd=total["flash_bwd"], vit=total["vit"],
                step_ms_p50=got["step_ms_p50"], tokens_s=got["tokens_s"],
                peak=got["peak_gib"] * 2**30, pinned=got["pinned_gib"] * 2**30, **ab)


# ---------------------------------------------------------------------------
# Phase 15: the mesh (``parallel/``) at full width, one process per rank
# ---------------------------------------------------------------------------

# Engines of phase 15, each on engine A's traffic (max_batch 8, EOS off):
# label -> (kind, keyword arguments, FUSED_APPEND, weight bits). A runs K8, B
# K4, V K3 (speculative verify windows), F K7; S1 is the slot engine (no
# paged kernel); D (int4 weights, bf16 pools) runs K8 with K10 in its
# prefills and K5 at decode, E (int8 weights, int8 pools) K4 with K10 in
# its prefills. The quantized weights are phase 4's, quantized whole leaf
# by leaf (a rank keeps its shards).
SHARDED_ENGINES = {
    "A": ("paged", {}, False, None),
    "B": ("paged", {"kv_quant": True}, False, None),
    "V": ("paged", {"speculative": 4}, False, None),
    "F": ("paged", {}, True, None),
    "S1": ("slot", {}, False, None),
    "D": ("paged", {}, False, 4),
    "E": ("paged", {"kv_quant": True}, False, 8),
}
# The paged kernel each engine launches once a layer per decode dispatch.
SHARDED_PAGED = {"A": "k8", "B": "q8", "V": "bf16", "F": "fused", "D": "k8", "E": "q8"}
# The LoRA stage of phase 15: rank, alpha and learning rate of
# scripts/v1_5/finetune_lora.sh, the adapters' generator seed, and a warm
# start: B drawn N(0, 1e-2), 50 x lr. From B = 0, Adam's sign-like first
# steps let rounding decide B's near-zero elements: one device against
# itself with only a model split's rounding changed reads 0.049 in step 3's
# A gradient norms, against 0.0079 from this start
# (scripts/lora_noise_check.py, PERF.md).
SHARDED_LORA = dict(rank=128, alpha=256.0, lr=2e-4, seed=17, b_std=1e-2)
SHARDED_MAX_NEW = 16
SHARDED_TRAIN_STEPS = 4
# Gates against the one-device run: prefill logits (the decoder's
# row-parallel sums round in another order; PR 15's int8-cache gap was
# 0.040-0.045), each step's loss, each adapter leaf's gradient norm.
SHARDED_LOGIT_REL_L2 = 0.05
SHARDED_LOSS_REL = 1e-2
SHARDED_NORM_REL = 3e-2


def sharded_form(n_cards: int) -> dict:
    """The mesh phase 15 runs on ``n_cards``, one NCCL rank per card: four
    cards (1, 2, 2), JAX's ``dryrun_multichip`` factorisation; two (1, 1,
    2); one card a one-rank group (1, 1, 1) that still takes the sharded
    path."""
    if n_cards >= 4:
        return dict(world=4, shape=(1, 2, 2))
    if n_cards >= 2:
        return dict(world=2, shape=(1, 1, 2))
    return dict(world=1, shape=(1, 1, 1))


def sharded_traffic(cfg, device="cuda") -> dict:
    """Engine A's traffic (phase 6's pictures) as host arrays a rank can
    take: the prompt ids and, per request, the preprocessed pixels."""
    from vcoder_tpu_torch.mm_tokens import tokenizer_depth_seg_token
    from vcoder_tpu_torch.simple_tokenizer import SimpleTokenizer

    tok = SimpleTokenizer.build_from_texts([PROMPT])
    rng = np.random.RandomState(11)
    ids = tokenizer_depth_seg_token(PROMPT, tok)
    preps = [_prepared(ids, _images(rng, h, w), SHARDED_MAX_NEW, device)[0]
             for h, w in ENGINE_SIZES]
    return dict(ids=list(ids), pixels=[(p.images, p.segs, p.depths) for p in preps])


def sharded_engines(cfg, weights, traffic, mesh, device, attn_impl="auto") -> dict:
    """Every engine of ``SHARDED_ENGINES`` on the traffic over its weights
    (``weights[bits]``: None the bf16 tree, 4 and 8 its quantized forms),
    over ``mesh`` (None: one device), the prefill
    attention on ``attn_impl``'s route: tokens, first-token logits, launch
    counts (set to 0 just before each engine, read just after), decode step
    p50 and count."""
    import torch

    from vcoder_tpu_torch.ops import paged_attention as pa
    from vcoder_tpu_torch.serve.engine import ServingEngine
    from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine

    out = {}
    for label, (kind, kw, fused, bits) in SHARDED_ENGINES.items():
        make = ServingEngine if kind == "slot" else PagedServingEngine
        pa.FUSED_APPEND = fused
        try:
            eng = make(cfg, weights[bits], max_batch=8, max_len=2048, eos_id=-1,
                       device=device, mesh=mesh, attn_impl=attn_impl, **kw)
            logits = {}
            first = eng._sample_first

            def keep(lg, req, first=first, logits=logits):
                logits[req.request_id] = lg.float().cpu()
                return first(lg, req)

            eng._sample_first = keep
            rids = [eng.add_request(traffic["ids"], images=i, segs=s, depths=d,
                                    max_new_tokens=SHARDED_MAX_NEW)
                    for i, s, d in traffic["pixels"]]
            _reset_counters()
            res = eng.run()
            _sync(device)
            counts = _counters()
            counts.update(bf16=pa.launches_bf16, q8=pa.launches_q8, fused=pa.launches_fused)
        finally:
            pa.FUSED_APPEND = False
        steps = eng.timer.samples.get("decode_step", [])
        out[label] = dict(tokens=[res[r] for r in rids],
                          logits=torch.stack([logits[r] for r in rids]),
                          counts=counts, step_p50_ms=float(np.median(steps)) * 1e3,
                          steps=len(steps))
        eng.close()
        del eng
    return out


def _stamp(device):
    """A start mark: a recorded CUDA event on CUDA, the host clock else."""
    import torch

    if torch.device(device).type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_ms(start, device) -> float:
    import torch

    if torch.device(device).type != "cuda":
        return (time.perf_counter() - start) * 1e3
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def sharded_training(cfg, params, mesh, device, stage: str = "vcoder_ds",
                     lora: dict = None) -> dict:
    """Phase 8's stage (vcoder_ds, 4 steps at a global B=4 over phase 8's
    samples, ``remat="dots"``) through ``Trainer`` over ``mesh`` (None: one
    device): losses, adapter gradient norms, CUDA-event step times, launch
    counts, and whether two frozen leaves (this rank's shards) kept every
    bit. ``stage="lora"``: the same over fresh adapters on every decoder
    product (``lora``, by default ``SHARDED_LORA``; each A drawn whole from
    one seeded generator, then sharded; B zero, or drawn by
    :func:`_warm_b` when ``b_std`` is set) at the LoRA recipe's learning
    rate, training them and ``mm_projector``. The leaves of ``params`` the stage trains in place
    are put back as they were at the end, so each stage starts from the
    seeded weights (a stage after another would start from the first one's
    sharded and one-device results, already apart)."""
    import torch

    from vcoder_tpu_torch.lora import add_lora
    from vcoder_tpu_torch.parallel import leaf_sharder
    from vcoder_tpu_torch.train.step import trainable_leaves
    from vcoder_tpu_torch.train.trainer import Trainer

    ds = DSSamples(20, cfg.vision.image_size)
    records = []
    start = {p: _local_copy(t) for p, t in trainable_leaves(params, stage).items()}
    train_params, probe = params, None
    lora = lora or SHARDED_LORA
    if stage == "lora":
        gen = torch.Generator(device=device).manual_seed(lora["seed"])
        train_params = add_lora(params, gen, rank=lora["rank"], alpha=lora["alpha"],
                                place=leaf_sharder(mesh))
        if lora["b_std"]:
            _warm_b(train_params, lora, mesh, device)
        # A corner of the first drawn A (gathered): the same draws everywhere.
        a = train_params["lm"]["layers"]["down_proj"].a
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        probe = a[0, :2, :4].float().cpu().tolist()
        del a
    with tempfile.TemporaryDirectory() as tmp:
        args = train_args(tmp)
        args.stage = stage
        if stage == "lora":
            args.learning_rate = lora["lr"]
        rows = mesh.row_shards if mesh is not None else 1
        args.per_device_train_batch_size //= rows
        trainer = Trainer(cfg, train_params, ds, args, mesh=mesh, device=device)
        frozen = {k: _local_copy(v) for k, v in (("q_proj", params["lm"]["layers"]["q_proj"]),
                                                 ("fc1", params["vision_tower"]["layers"]["fc1"]))}
        inner = trainer.step_fn

        def timed_step(p, state, batch):
            t0 = _stamp(device)
            res = inner(p, state, batch)
            records.append(dict(ms=_elapsed_ms(t0, device), norms={
                k: float(v) for k, v in res[2]["leaf_grad_norms"].items()}))
            return res

        trainer.step_fn = timed_step
        _reset_counters()
        hist = trainer.train(max_steps=SHARDED_TRAIN_STEPS)
        _sync(device)
        counts = _counters()
        kept = all(torch.equal(_local_copy(v), frozen[k]) for k, v in
                   (("q_proj", params["lm"]["layers"]["q_proj"]),
                    ("fc1", params["vision_tower"]["layers"]["fc1"])))
        with torch.no_grad():
            for p, t in trainable_leaves(params, stage).items():
                (t.to_local() if hasattr(t, "to_local") else t).copy_(start[p])
        del trainer, frozen, train_params, start
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return dict(losses=[h["loss"] for h in hist], norms=[r["norms"] for r in records],
                step_ms=[r["ms"] for r in records], counts=counts, frozen_kept=kept,
                probe=probe)


def _warm_b(tree, lora: dict, mesh, device) -> None:
    """Every adapter's B of ``tree`` drawn N(0, ``b_std``) in place, each
    whole from one generator seeded ``seed + 1`` in path order (the same
    draws on every rank and on one device), a rank keeping its shard."""
    import torch

    from vcoder_tpu_torch.lora import LoraWeight
    from vcoder_tpu_torch.parallel.sharding import shard_leaf

    gen = torch.Generator(device=device).manual_seed(lora["seed"] + 1)
    layers = tree["lm"]["layers"]
    with torch.no_grad():
        for name in sorted(layers):
            b = layers[name].b if isinstance(layers[name], LoraWeight) else None
            if b is None:
                continue
            whole = torch.randn(b.shape, generator=gen, device=device, dtype=torch.float32)
            whole = whole.mul_(lora["b_std"]).to(b.dtype)
            if hasattr(b, "to_local"):
                path = f"lm/layers/{name}"
                whole = shard_leaf(f"{path}/b", whole, mesh, rule_path=path)
                assert whole.placements == b.placements, (path, whole.placements)
                whole, b = whole.to_local(), b.to_local()
            b.copy_(whole)


def _local_copy(t):
    from torch.distributed.tensor import DTensor

    return (t.to_local() if isinstance(t, DTensor) else t).clone()


def _quantized_trees(params, mesh) -> tuple:
    """Phase 4's weights quantized to int4 and to int8 (``quantize_params``,
    the bf16 tree kept): each leaf whole, then placed over ``mesh`` when it
    is distributed."""
    from vcoder_tpu_torch.parallel import leaf_sharder
    from vcoder_tpu_torch.quant import quantize_params

    place = leaf_sharder(mesh)
    return tuple(quantize_params(params, bits=b, destroy=False, place=place) for b in (4, 8))


def _sharded_rank(rank, world, form, traffic, device):
    """One rank of phase 15: the 7B weights from phase 4's seed (the same on
    every rank; each keeps its shards), quantized leaf by leaf, the engines,
    then the training stages (they move the adapters in place, so they run
    last)."""
    import torch

    from vcoder_tpu_torch.parallel import leaf_sharder, make_mesh

    cuda = torch.device(device).type == "cuda"
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    shape = form["shape"]
    mesh = make_mesh([dev] * world, data=shape[0], fsdp=shape[1], model=shape[2])

    def peak_gib():
        return torch.cuda.max_memory_allocated(dev) / 2**30 if cuda else 0.0

    def held_gib():
        return torch.cuda.memory_allocated(dev) / 2**30 if cuda else 0.0

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg, params, _, _ = build_model(device=dev, quiet=rank != 0, place=leaf_sharder(mesh))
    build_peak, held = peak_gib(), held_gib()
    leaves = list(_flat(params).values())
    leaf = max(t.numel() * t.element_size() for t in leaves) / 2**30
    shards = sum((t.to_local() if hasattr(t, "to_local") else t).numel() * t.element_size()
                 for t in leaves) / 2**30
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    q4, q8 = _quantized_trees(params, mesh)
    quant_peak, quant_held = peak_gib(), held_gib()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    engines = sharded_engines(cfg, {None: params, 4: q4, 8: q8}, traffic, mesh, dev)
    del q4, q8
    if cuda:
        torch.cuda.empty_cache()
    train = sharded_training(cfg, params, mesh, dev)
    lora = sharded_training(cfg, params, mesh, dev, stage="lora")
    return dict(engines=engines, train=train, lora=lora, device=str(dev),
                build_peak_gib=build_peak, held_gib=held, shards_gib=shards, leaf_gib=leaf,
                quant_peak_gib=quant_peak, quant_held_gib=quant_held, peak_gib=peak_gib(),
                mesh=mesh.shape, row=mesh.row_index, model_rank=mesh.local_rank("model"))


# Rows of the row-parallel product check: about one prefill's tokens; and a
# decode step's rows for the quantized products below the W8A8 threshold.
ROW_SPLIT_M = 1232
ROW_SPLIT_DECODE_M = 8


def _split_gates(name: str, full, parts, halves_plain, partial_dtype) -> dict:
    """The f32 partials summed then rounded once against ``full`` (one
    device's product), beside the half products summed in the output dtype;
    raises unless the partials are f32 and nearer in relative L2 and in the
    share of elements that differ."""
    import torch

    routes = {"f32": (parts[0] + parts[1]).to(full.dtype), "bf16": halves_plain}
    res = {"partial_dtype": str(partial_dtype).replace("torch.", "")}
    for route, y in routes.items():
        res[route] = dict(rel_l2=_rel_l2(y, full), differ=float((y != full).float().mean()))
    if (partial_dtype != torch.float32 or res["f32"]["rel_l2"] > res["bf16"]["rel_l2"]
            or res["f32"]["differ"] > res["bf16"]["differ"]):
        raise SystemExit(f"row-parallel check {name}: {res}")
    return res


def check_row_split(params, device="cuda") -> dict:
    """The row-parallel products of a model split of 2 against one device's
    product, on one card: layer 0's o_proj [4096, 4096] and down_proj
    [11008, 4096] at the 7B shapes, seeded bf16 activations, the
    contraction split in halves as two model ranks hold it.

    * bf16 weights at ``ROW_SPLIT_M`` rows: ``spmd.partial_product``'s f32
      partials (the branch ``row_parallel`` takes in the engines' forward)
      summed, then rounded once, against each half's bf16 product summed in
      bf16;
    * int8 (the upcast) and int4 (K5's f32 form) weights at
      ``ROW_SPLIT_DECODE_M`` rows, the same way;
    * int8 weights at ``ROW_SPLIT_M`` rows, W8A8: the row absmax of both
      halves (the all-reduce's max), each half's s32 product through K10's
      s32 form, summed, and the f32 epilogue once (what
      ``quant.w8a8_matmul`` does over a model group), against one device's
      K10 scaled product: equal within one bf16 rounding per element, and
      nearer than each half quantized by its own absmax and summed. This
      holds the arithmetic of the group branch (its ``quantize_rows`` and
      ``w8a8_epilogue``) at the split shapes; ``w8a8_matmul(group=)``
      itself, with its all-reduces, runs only over a real model split
      (phase 15 on four cards).

    Gates: the partials are f32 and their gap to the full product is no
    larger than the half products' in relative L2 and in the share of
    elements that differ; the W8A8 split as above."""
    import torch

    from vcoder_tpu_torch.ops import int8_matmul as i8
    from vcoder_tpu_torch.ops import quant as oq
    from vcoder_tpu_torch.ops.quant import qmatmul as qm
    from vcoder_tpu_torch.parallel import spmd
    from vcoder_tpu_torch.quant import _quantize_leaf

    gen = torch.Generator(device=device).manual_seed(21)
    out = {}
    with torch.no_grad():
        for name in ("o_proj", "down_proj"):
            w = params["lm"]["layers"][name][0]
            K, h = w.shape[0], w.shape[0] // 2
            x = torch.randn((ROW_SPLIT_M, K), generator=gen, device=device, dtype=w.dtype)
            full = qm(x, w)
            halves = [(x[:, :h].contiguous(), w[:h]), (x[:, h:].contiguous(), w[h:])]
            parts = [spmd.partial_product(a, b, qm) for a, b in halves]
            out[name] = _split_gates(name, full, parts, qm(*halves[0]) + qm(*halves[1]),
                                     parts[0].dtype)
            xd = x[:ROW_SPLIT_DECODE_M]
            for bits in (8, 4):
                qw = _quantize_leaf(w, bits)
                hq = h // 2 if bits == 4 else h
                qh = [oq.QuantizedTensor(qw.q[:hq], qw.scale, bits),
                      oq.QuantizedTensor(qw.q[hq:], qw.scale, bits)]
                xh = [xd[:, :h].contiguous(), xd[:, h:].contiguous()]
                parts = [spmd.partial_product(a, b, qm) for a, b in zip(xh, qh)]
                label = f"{name} {'int8 upcast' if bits == 8 else 'int4 K5'}"
                out[label] = _split_gates(label, qm(xd, qw), parts,
                                          qm(xh[0], qh[0]) + qm(xh[1], qh[1]), parts[0].dtype)
            # W8A8 (K10): the absmax of both halves, exact s32 sums.
            qw = _quantize_leaf(w, 8)
            xh = [x[:, :h].contiguous(), x[:, h:].contiguous()]
            full = oq.w8a8_matmul(x, qw)
            amax = torch.maximum(*(t.float().abs().amax(-1, keepdim=True) for t in xh))
            quantized = [oq.quantize_rows(t, amax) for t in xh]
            acc = (i8.int8_mm(quantized[0][0], qw.q[:h].contiguous())
                   + i8.int8_mm(quantized[1][0], qw.q[h:].contiguous()))
            split = oq.w8a8_epilogue(acc, quantized[0][1], qw.scale, x.dtype)
            own = sum(oq.w8a8_matmul(t.float(), oq.QuantizedTensor(q, qw.scale)) for t, q in
                      zip(xh, (qw.q[:h], qw.q[h:]))).to(x.dtype)
            rel = ((split.float() - full.float()).abs()
                   / full.float().abs().clamp_min(1e-30)).max().item()
            res = dict(max_rel=rel, bit_equal=bool(torch.equal(split, full)),
                       rel_l2=_rel_l2(split, full), own_absmax_rel_l2=_rel_l2(own, full))
            out[f"{name} int8 W8A8 K10"] = res
            if rel > 2.0 ** -8 or res["rel_l2"] >= res["own_absmax_rel_l2"]:
                raise SystemExit(f"row-parallel check {name} W8A8: {res}")
    log("row split (model = 2, one card): " + json.dumps(out))
    return out


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _train_gaps(t: dict, rt: dict, label: str, bad: list) -> dict:
    """A training run's losses and per-leaf gradient norms against the
    one-device run's (``SHARDED_LOSS_REL``, ``SHARDED_NORM_REL``; a norm that
    is 0 on one device must be 0 here), appending failures to ``bad``."""
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(t["losses"], rt["losses"])]
    rels = [((abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) if b[k] else abs(a[k])), i, k)
            for i, (a, b) in enumerate(zip(t["norms"], rt["norms"])) for k in b]
    norm_rel, at_step, at_leaf = max(rels)
    if t["probe"] != rt["probe"]:
        bad.append(f"{label}: adapters drawn differently ({t['probe']} vs {rt['probe']})")
    if len(t["losses"]) != SHARDED_TRAIN_STEPS or max(loss_rel) > SHARDED_LOSS_REL:
        bad.append(f"{label} losses {t['losses']} vs one device {rt['losses']}")
    if norm_rel > SHARDED_NORM_REL:
        bad.append(f"{label} gradient norms rel {norm_rel:.4f} (bound {SHARDED_NORM_REL})")
    worst = [max((abs(a[k] - b[k]) / max(abs(b[k]), 1e-12), k) for k in b if b[k])
             for a, b in zip(t["norms"], rt["norms"])]
    return dict(loss_rel_max=round(max(loss_rel), 6), norm_rel_max=round(norm_rel, 6),
                norm_rel_at=(at_step + 1, at_leaf), norm_rel_by_step=[
                    (round(r, 6), k) for r, k in worst],
                losses=[round(x, 5) for x in t["losses"]],
                one_device_losses=[round(x, 5) for x in rt["losses"]],
                step_ms=[round(x, 1) for x in t["step_ms"]],
                one_device_step_ms=[round(x, 1) for x in rt["step_ms"]])


def _k10(c: dict) -> int:
    """K10's launches in both forms (a row-parallel W8A8 product over a
    model split runs the s32 form, summed exactly over ``model``)."""
    return c["int8"] + c["int8_scaled"]


def phase_sharded(device: str = "cuda") -> dict:
    """Phase 15: training and both serving engines over a mesh, one process
    per rank (``parallel/launch.spawn``: NCCL on the cards, gloo on the CPU),
    against the one-device run computed first in this process on the
    routes a mesh takes: the tower on the unfused blocks (the fused tower's
    own gap from them reads ~0.05 relative L2 in the logits) and the B=1
    prefills on the plain attention route where the row shards cannot
    split one row.
    First, on one card, :func:`check_row_split`. Gates: the build of each
    rank held no more than its shards and one whole leaf, and its
    quantization no more than what it keeps and two whole bf16 leaves;
    every rank returns the same tokens and losses; prefill logits of every
    engine within ``SHARDED_LOGIT_REL_L2`` of the one-device run and every
    first token equal (the share of equal later tokens reported); each
    step's loss within ``SHARDED_LOSS_REL`` and each trained leaf's gradient
    norm within ``SHARDED_NORM_REL``, for the vcoder_ds and the lora stage;
    frozen weights unchanged; per rank, K1 64 and K6 32 per training step,
    32 launches per decode dispatch of K8 (A, D), K4 (B, E), K3 (V) and K7
    (F), no paged launch in S1, K5 and K10 (both forms) as many as on one
    device for D and E (none elsewhere), and no K2 or K9 under the mesh
    (launch gates on CUDA only: the CPU routes launch nothing). Returns
    rank 0's launch counts."""
    import torch

    from vcoder_tpu_torch.parallel import launch

    cuda = torch.device(device).type == "cuda"
    n_cards = torch.cuda.device_count() if cuda else 1
    form = sharded_form(n_cards)
    log(f"mesh (phase 15): {n_cards} card(s) -> {form['world']} rank(s), mesh (data, fsdp, "
        f"model) = {form['shape']}")
    t0 = time.perf_counter()
    from vcoder_tpu_torch.models import clip

    cfg, params, _, _ = build_model(device=device)
    row_split = check_row_split(params, device) if cuda else None
    traffic = sharded_traffic(cfg, device)
    # The one-device run takes the routes a mesh takes, so the gaps are the
    # sharding's: the tower's unfused blocks (as JAX's clip.py:138-140), and
    # for the B=1 prefills the plain attention route where the mesh's row
    # shards do not divide one row.
    rows = form["shape"][0] * form["shape"][1]
    route = "auto" if rows == 1 else "xla"
    clip.FUSED_BLOCKS = False
    try:
        q4, q8 = _quantized_trees(params, None)
        weights = {None: params, 4: q4, 8: q8}
        ref_eng = sharded_engines(cfg, weights, traffic, None, device, attn_impl=route)
        del weights
        del q4, q8
        if cuda:
            torch.cuda.empty_cache()
        ref_train = sharded_training(cfg, params, None, device)
        ref_lora = sharded_training(cfg, params, None, device, stage="lora")
    finally:
        clip.FUSED_BLOCKS = True
    del params
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    t1 = time.perf_counter()
    ranks = launch.spawn(_sharded_rank, form["world"], form, traffic, device, device=device,
                         timeout_s=600)
    t_ranks = time.perf_counter() - t1
    bad = []
    r0 = ranks[0]
    for r, res in enumerate(ranks[1:], 1):
        for label in SHARDED_ENGINES:
            if res["engines"][label]["tokens"] != r0["engines"][label]["tokens"]:
                bad.append(f"rank {r} engine {label} tokens differ from rank 0's")
        for key in ("train", "lora"):
            if res[key]["losses"] != r0[key]["losses"]:
                bad.append(f"rank {r} {key} losses differ from rank 0's")
    for r, res in enumerate(ranks if cuda else ()):
        for label, (kind, kw, fused, bits) in SHARDED_ENGINES.items():
            e, c = res["engines"][label], res["engines"][label]["counts"]
            ref_c = ref_eng[label]["counts"]
            want = SHARDED_PAGED.get(label)
            paged = {k: c[k] for k in ("k8", "q8", "bf16", "fused")}
            expect = {k: (32 * e["steps"] if k == want else 0) for k in paged}
            if paged != expect or c["vit"] or c["mlp"]:
                bad.append(f"rank {r} engine {label}: launches {c}, want {expect}, no K2/K9")
            quant = (c["int4"], _k10(c))
            if quant != (ref_c["int4"], _k10(ref_c)) or (bits is not None) != (_k10(c) > 0) \
                    or (bits == 4) != (c["int4"] > 0):
                bad.append(f"rank {r} engine {label}: K5/K10 launches {quant}, one device "
                           f"{(ref_c['int4'], _k10(ref_c))}")
        for key in ("train", "lora"):
            c = res[key]["counts"]
            if (c["flash"], c["flash_bwd"], c["vit"]) != (64 * SHARDED_TRAIN_STEPS,
                                                           32 * SHARDED_TRAIN_STEPS, 0):
                bad.append(f"rank {r} {key} training launches {c}")
    for r, res in enumerate(ranks):
        for key in ("train", "lora"):
            if not res[key]["frozen_kept"]:
                bad.append(f"rank {r} {key}: a frozen weight changed")
        # Leaf by leaf: the build never held more than the shards and one
        # whole leaf (its largest) at once; quantization (each leaf gathered
        # whole, quantized, then sliced) no more than its outcome and two.
        if cuda and (res["build_peak_gib"] > res["held_gib"] + 1.05 * res["leaf_gib"] + 0.1
                     or res["held_gib"] > res["shards_gib"] + 0.1):
            bad.append(f"rank {r}: build peak {res['build_peak_gib']:.2f} GiB, holding "
                       f"{res['held_gib']:.2f} GiB for {res['shards_gib']:.2f} GiB of shards "
                       f"(bound: shards + one {res['leaf_gib']:.2f} GiB leaf)")
        if cuda and res["quant_peak_gib"] > res["quant_held_gib"] + 2 * res["leaf_gib"] + 0.25:
            bad.append(f"rank {r}: quantization peak {res['quant_peak_gib']:.2f} GiB, holding "
                       f"{res['quant_held_gib']:.2f} GiB (bound: + two {res['leaf_gib']:.2f} "
                       f"GiB leaves)")
    gaps = {}
    for label in SHARDED_ENGINES:
        got, ref = r0["engines"][label], ref_eng[label]
        rel = [_rel_l2(a, b) for a, b in zip(got["logits"], ref["logits"])]
        firsts = [a[0] == b[0] for a, b in zip(got["tokens"], ref["tokens"])]
        later = [x == y for a, b in zip(got["tokens"], ref["tokens"])
                 for x, y in zip(a[1:], b[1:])]
        gaps[label] = dict(logit_rel_l2_max=round(max(rel), 5), first_equal=sum(firsts),
                           later_equal=round(sum(later) / len(later), 4),
                           step_p50_ms=round(got["step_p50_ms"], 2),
                           one_device_step_p50_ms=round(ref["step_p50_ms"], 2))
        if max(rel) > SHARDED_LOGIT_REL_L2 or not all(firsts):
            bad.append(f"engine {label}: prefill logits rel L2 {max(rel):.4f} (bound "
                       f"{SHARDED_LOGIT_REL_L2}), first tokens equal {sum(firsts)}/{len(firsts)}")
    train_gaps = _train_gaps(r0["train"], ref_train, "training", bad)
    lora_gaps = _train_gaps(r0["lora"], ref_lora, "lora training", bad)
    summary = dict(
        form=form, row_split=row_split, reference_s=round(t_ref, 1),
        ranks_s=round(t_ranks, 1), gaps=gaps, train=train_gaps, lora=lora_gaps,
        build_peak_gib=[round(r["build_peak_gib"], 2) for r in ranks],
        held_gib=[round(r["held_gib"], 2) for r in ranks],
        shards_gib=[round(r["shards_gib"], 2) for r in ranks],
        quant_peak_gib=[round(r["quant_peak_gib"], 2) for r in ranks],
        quant_held_gib=[round(r["quant_held_gib"], 2) for r in ranks],
        peak_gib=[round(r["peak_gib"], 2) for r in ranks],
        launches_one_device={k: v["counts"] for k, v in ref_eng.items() if k in ("D", "E")},
        launches_rank0={"train": r0["train"]["counts"], "lora": r0["lora"]["counts"],
                        **{k: v["counts"] for k, v in r0["engines"].items()}})
    log("sharded: " + json.dumps(summary))
    if bad:
        raise SystemExit("mesh phase: " + "; ".join(bad))
    runs = [r0["train"]["counts"], r0["lora"]["counts"]]
    total = dict(flash=sum(c["flash"] for c in runs), flash_bwd=sum(c["flash_bwd"] for c in runs),
                 train_flash=sum(c["flash"] for c in runs))
    for key in ("k8", "q8", "bf16", "fused", "int4", "int8", "int8_scaled"):
        total[key] = sum(e["counts"][key] for e in r0["engines"].values())
    total["flash"] += sum(e["counts"]["flash"] for e in r0["engines"].values())
    return total


# Phase 16: VCoder-DS-13B on one card. D13 serves the capacity batch of 16:
# engine A's 8 pictures (the same seed), then 8 more sizes.
DIR_13B = "vcoder_ds_llava-v1.5-13b"
CAPACITY_SIZES = ENGINE_SIZES + [(448, 336), (560, 720), (300, 420), (700, 500), (384, 512),
                                 (420, 630), (800, 600), (360, 480)]
# The card machine takes ~45 GiB of writes a call, deleted files included;
# phase 10's and phase 16's checkpoint directories are nearly all of them.
DISK_BUDGET_GIB = 44.0
# The in-place int8 quantization's peak over the bf16 tree it starts from:
# the largest int8 leaf (gate/up, 2.6 GiB) made before its bf16 leaf frees,
# and one layer's f32 transients.
QUANT_PEAK_GIB = 4.0
W8A8_PRODUCTS_13B = 7 * 40 + 6 * 23  # decoder and tower products of a W8A8 prefill


def _quant_engine_gate(label: str, c: dict, n: int, L: int, int4: bool) -> None:
    """A quantized engine's counters over ``n`` admissions: ``L`` flash
    launches and 418 scaled K10 products per admission, ``L`` K4 launches per
    decode step (int8 pools), no ViT block (the quantized tower is unfused),
    and with int4 weights 7 L + 1 K5 launches per decode step and 1 per
    admission (the LM head on the last prompt token)."""
    d = c["decode_dispatches"]
    want = dict(flash=L * n, vit=0, int8_scaled=W8A8_PRODUCTS_13B * n, int8=0, q8=L * d,
                int4=(7 * L + 1) * d + n if int4 else 0)
    got = {k: c[k] for k in want}
    if got != want or c["bf16"] or c["k8"] or c["fused"]:
        raise SystemExit(f"engine {label}: launches {c} != {want} (bf16/k8/fused must be 0)")


def phase_13b(disk_gib: float, then=None) -> dict:
    """Phase 16: VCoder-DS-13B at full width and depth (40 decoder layers,
    23 CLIP blocks), seeded random bf16 weights, EOS off, after every 7B
    tree is released. 16a: phase 4's 3 requests through ``generate`` (40
    K1 and 23 K2 launches a prefill). 16b: engine A13, bf16 pools,
    ``max_batch`` 8, engine A's 8 requests (40 K8 a decode step, 40/23 per
    admission), its tokens beside ``generate``'s on the same requests. 16c:
    the tree saved as a ``vcoder_ds_llava-v1.5-13b`` directory (the run's
    writes reckoned with ``disk_gib``, phase 10's, and gated), then quantized
    to int8 in place on the card; engine E13, int8 weights and pools,
    ``max_batch`` 4, 4 requests (418 scaled K10 an admission, 40 K4 a step);
    the B=1 prefill logits with W8A8 on and off. 16d: the int8 tree freed,
    the directory loaded by ``load_pretrained_model(load_4bit=True)``;
    engine D13, int4 weights, int8 pools, ``max_batch`` 16, 16 requests (281
    K5 a step + 1 an admission, 418 K10, 40 K4). ``then(dir)`` runs once
    the int4 tree is freed, before the directory is deleted (phase 17).
    Returns the launch totals and the readings."""
    import gc

    import torch

    from vcoder_tpu_torch.builder import load_pretrained_model
    from vcoder_tpu_torch.checkpoint import save_pretrained
    from vcoder_tpu_torch.mm_tokens import tokenizer_depth_seg_token
    from vcoder_tpu_torch.ops import quant as oq
    from vcoder_tpu_torch.quant import quantize_params

    t_phase = time.perf_counter()
    laps, out = {}, {}
    gib = lambda x: round(x / 2**30, 2)  # noqa: E731
    gc.collect()
    torch.cuda.empty_cache()
    _host_empty_cache()  # pinned blocks the offloaded stage left cached
    log(f"  before the phase: {gib(torch.cuda.memory_allocated())} GiB allocated (no 7B tree "
        f"held), host RSS {_rss_gib():.1f} GiB")
    cfg, params, model, tok = build_model("13b")
    L = cfg.text.num_layers
    out["bf16_gib"] = gib(torch.cuda.memory_allocated())
    laps["build"] = round(time.perf_counter() - t_phase, 1)

    log("  16a: B=1 generate, phase 4's requests")
    main = phase_main_path(cfg, params, model, tok, profile=False)
    out.update(ttft_p50_ms=round(main["ttft_p50_ms"], 1),
               decode_tok_s_p50=round(main["decode_tok_s_p50"], 1))
    totals = dict(flash=main["flash_fwd"], vit=main["vit_block"])
    laps["16a"] = round(time.perf_counter() - t_phase - sum(laps.values()), 1)

    ids = tokenizer_depth_seg_token(PROMPT, tok)
    rng = np.random.RandomState(11)
    reqs = [_prepared(ids, _images(rng, h, w), 32) for h, w in CAPACITY_SIZES]
    preps = [p for p, _ in reqs]
    (res_a,), st = _run_engine("A13 (bf16 pools)", cfg, params, [preps[:8]], max_new=32,
                               model_name=DIR_13B)
    c = st["counts"][0]
    if (c["k8"] != L * c["decode_dispatches"] or c["bf16"] or c["q8"] or c["fused"]
            or c["flash"] != L * 8 or c["vit"] != 23 * 8):
        raise SystemExit(f"engine A13: launches {c}, want {L} K8 a decode step and {L}/23 "
                         f"flash/ViT an admission")
    first = later = 0
    for (_, px), r in zip(reqs[:8], res_a):
        g = model.generate([ids], *px, max_new_tokens=32).sequences[0].tolist()
        first += int(g[0] == r["tokens"][0])
        later += sum(int(x == y) for x, y in zip(g[1:], r["tokens"][1:]))
    torch.cuda.synchronize()
    log(f"  A13 vs dense generate (prompt padded to 1280, not the engine's 1536 bucket): first "
        f"tokens {first}/8 agree, decode tokens {later}/{8 * 31}")
    out["A13"] = dict(ttft_p50_ms=round(st["ttft_p50_ms"][0], 1),
                      step_p50_ms=round(st["step_p50_ms"][0], 2),
                      decode_tok_s=round(st["decode_tok_s"][0], 1), pools_gib=round(st["pool_gib"], 2),
                      first_agree=first, later_agree=later)
    for k in ("flash", "vit", "k8"):
        totals[k] = totals.get(k, 0) + c[k]
    laps["16b"] = round(time.perf_counter() - t_phase - sum(laps.values()), 1)

    tmp = tempfile.mkdtemp(prefix="vcoder_13b_")
    try:
        d = os.path.join(tmp, DIR_13B)
        t0 = time.perf_counter()
        save_pretrained(d, params, cfg)
        full_vocab_tokenizer(cfg).save_pretrained(d)
        laps["save"] = round(time.perf_counter() - t0, 1)
        size = _dir_gib(d)
        out["dir_gib"], out["written_gib"] = round(size, 2), round(disk_gib + size, 2)
        log(f"  16c: save_pretrained {size:.2f} GiB in {laps['save']} s; the run's checkpoint "
            f"writes {disk_gib:.2f} + {size:.2f} = {disk_gib + size:.2f} GiB (budget "
            f"{DISK_BUDGET_GIB} GiB)")
        if disk_gib + size > DISK_BUDGET_GIB:
            raise SystemExit(f"phase 16: {disk_gib + size:.2f} GiB of checkpoint writes exceed "
                             f"the budget of {DISK_BUDGET_GIB} GiB")

        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        quantize_params(params, bits=8)  # in place: the model's tree is this one
        torch.cuda.synchronize()
        laps["quantize"] = round(time.perf_counter() - t0, 1)
        over = torch.cuda.max_memory_allocated() - before
        out["int8_gib"], out["quant_peak_over_bf16_gib"] = (gib(torch.cuda.memory_allocated()),
                                                            gib(over))
        log(f"  quantize_params(bits=8) in place: {out['int8_gib']} GiB int8 tree from "
            f"{gib(before)} GiB bf16 in {laps['quantize']} s; peak {gib(over)} GiB over the bf16 "
            f"tree (bound {QUANT_PEAK_GIB})")
        if over > QUANT_PEAK_GIB * 2**30:
            raise SystemExit(f"phase 16: in-place quantization peaked {gib(over)} GiB over the "
                             f"bf16 tree")
        _, st = _run_engine("E13 (int8 weights, int8 pools)", cfg, params, [preps[:4]],
                            max_new=32, max_batch=4, model_name=DIR_13B, kv_quant=True)
        c = st["counts"][0]
        _quant_engine_gate("E13", c, 4, L, int4=False)
        out["E13"] = dict(ttft_p50_ms=round(st["ttft_p50_ms"][0], 1),
                          step_p50_ms=round(st["step_p50_ms"][0], 2),
                          decode_tok_s=round(st["decode_tok_s"][0], 1),
                          pools_gib=round(st["pool_gib"], 2))
        for k in ("flash", "q8", "int8_scaled"):
            totals[k] = totals.get(k, 0) + c[k]
        pictures = _images(np.random.RandomState(7), 480, 640)
        on, _, _ = _prefill_routes(params, cfg, tok, pictures, plain=False)
        oq.set_w8a8(False)
        try:
            off, _, _ = _prefill_routes(params, cfg, tok, pictures, plain=False)
        finally:
            oq.set_w8a8(True)
        gap = ((on.float() - off.float()).norm() / off.float().norm()).item()
        out["w8a8_gap_rel_l2"] = gap
        log(f"  E13's B=1 prefill logits, W8A8 on against off (bf16 upcast): relative L2 "
            f"{gap:.4e}, argmax {int(on.argmax())} vs {int(off.argmax())} (a reading)")
        laps["16c"] = round(time.perf_counter() - t_phase - sum(laps.values()), 1)

        del params, model, on, off
        gc.collect()
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, model4, *_ = load_pretrained_model(d, load_4bit=True)
        torch.cuda.synchronize()
        laps["load_4bit"] = round(time.perf_counter() - t0, 1)
        out["load_s"] = laps["load_4bit"]
        out["load_peak_gib"] = gib(torch.cuda.max_memory_allocated() - held)
        out["int4_gib"] = gib(torch.cuda.memory_allocated() - held)
        log(f"  16d: load_pretrained_model(load_4bit=True) in {laps['load_4bit']} s: "
            f"{out['int4_gib']} GiB int4 tree, peak {out['load_peak_gib']} GiB over the load "
            f"({gib(held)} GiB held before), host RSS {_rss_gib():.1f} GiB")
        cfg4 = model4.config
        if cfg4.text.num_layers != L or cfg4.model_type != cfg.model_type:
            raise SystemExit(f"phase 16: the 13B directory loaded as {cfg4.model_type}, "
                             f"{cfg4.text.num_layers} layers")
        torch.cuda.reset_peak_memory_stats()
        _, st = _run_engine("D13 (int4 weights, int8 pools)", cfg4, model4.params, [preps],
                            max_new=32, max_batch=16, model_name=DIR_13B, kv_quant=True)
        c = st["counts"][0]
        _quant_engine_gate("D13", c, 16, L, int4=True)
        out["D13"] = dict(ttft_p50_ms=round(st["ttft_p50_ms"][0], 1),
                          step_p50_ms=round(st["step_p50_ms"][0], 2),
                          decode_tok_s=round(st["decode_tok_s"][0], 1),
                          pools_gib=round(st["pool_gib"], 2),
                          peak_gib=gib(torch.cuda.max_memory_allocated()))
        for k in ("flash", "q8", "int4", "int8_scaled"):
            totals[k] = totals.get(k, 0) + c[k]
        del model4
        gc.collect()
        torch.cuda.empty_cache()
        laps["16d"] = round(time.perf_counter() - t_phase - sum(laps.values()), 1)
        if then is not None:
            then(d)
            laps["then"] = round(time.perf_counter() - t_phase - sum(laps.values()), 1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    laps["phase"] = round(time.perf_counter() - t_phase, 1)
    out["laps"] = laps
    log(f"phase16: {json.dumps(out)}")
    return totals


# ---------------------------------------------------------------------------
# Phase 17: VCoder-DS-13B training, in phase 16's 13B directory
# ---------------------------------------------------------------------------

TRAIN_STEPS_13B = 4
# 17b, scripts/v1_5/vcoder_it_lora.sh's recipe: adapters of rank 128, alpha
# 256, over every decoder product, lr 2e-4, 16 rows a device per update.
IT_LORA_FLAGS = ("--lora-enable", "--lora-r", "128", "--lora-alpha", "256",
                 "--learning-rate", "2e-4")
IT_LORA_ROWS = 16
# The largest of 4, 2, 1 whose micro-batch fits an 80 GB card, as
# ``scripts/phase17.py --find-it-lora-batch`` finds it: at B=4 (T=1536) the
# step runs out of memory with 74.3 GiB allocated (PERF.md), LoRA's outputs
# doubling the products remat "dots" saves.
IT_LORA_BATCH = 2
# The first update runs at lr 0 (the warmup's first point), so b is still 0
# through the second update and a's gradient is 0 until the third.
IT_LORA_UPDATES = 3
LLAVA_DIR_13B = "llava-v1.5-13b"
# The merge's peak over what is held before it: at most the merged weights
# plus this (one layer's f32 fold and the allocator's rounding).
MERGE_SLACK_GIB = 2.0
# 17a's peak as estimated before the first run: the 25.35 GiB tree and ~41
# GiB of activations under remat "dots" at B=4, T=2048. The measured peak
# is gated at it, ~11 GiB below the card's 79.2 usable.
PEAK_ESTIMATE_GIB = 68.0


def train_launch_gate(label: str, counts: dict, layers: int, steps: int) -> None:
    """Per step (or micro-batch) of a decoder of ``layers`` layers: ``2 x
    layers`` K1 launches (the forward and its recomputation under remat),
    ``layers`` K6 calls and 23 ViT blocks (one tower pass), and no other
    kernel."""
    want = dict(flash=2 * layers * steps, flash_bwd=layers * steps, vit=23 * steps, mlp=0, k8=0,
                paged=0, int4=0, int8=0, int8_scaled=0)
    if counts != want:
        raise SystemExit(f"{label}: launches {counts} != {want}")


@contextlib.contextmanager
def measured_merge(out: dict, device: str = "cuda"):
    """Read each ``lora.merge_lora`` call made inside the block: its seconds,
    the bytes of the weights it merged, what was held on the device before
    it and its peak over that (the peak before it goes to ``train_peak``)."""
    import torch

    from vcoder_tpu_torch import lora as lora_mod

    merge = lora_mod.merge_lora
    cuda = torch.device(device).type == "cuda"

    def measured(params):
        held = float("nan")
        if cuda:
            torch.cuda.synchronize()
            out["train_peak"] = torch.cuda.max_memory_allocated()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        merged = merge(params)
        _sync(device)
        out["s"] = time.perf_counter() - t0
        src, dst = _flat(params), _flat(merged)
        out["merged"] = sum(dst[k].numel() * dst[k].element_size() for k, x in src.items()
                            if isinstance(x, lora_mod.LoraWeight))
        out["held"] = held
        out["over"] = torch.cuda.max_memory_allocated() - held if cuda else 0
        return merged

    lora_mod.merge_lora = measured
    try:
        yield out
    finally:
        lora_mod.merge_lora = merge


def _step_readings(res: dict, B: int) -> dict:
    """Each step logged; steps 2-N p50 ms (CUDA events) and valid tokens/s."""
    records = res["records"]
    for m, r in zip(res["metrics"], records):
        log(f"    step {m['step']}: T={r['T']} B={B}, {r['tokens']} tokens, {r['ms']:.1f} ms, "
            f"{r['tokens'] / r['ms'] * 1e3:.0f} tokens/s, loss {m['loss']:.4f}, grad_norm "
            f"{m['grad_norm']:.4f}")
    return dict(step_ms_p50=float(np.median([r["ms"] for r in records[1:]])),
                tokens_s=float(np.median([r["tokens"] / r["ms"] * 1e3 for r in records[1:]])),
                T=records[0]["T"], losses=[m["loss"] for m in res["metrics"]])


def _final_gate(res: dict, model_type: str, layers: int) -> list:
    fc = res["final_config"]
    if (fc.get("model_type"), fc.get("num_hidden_layers")) != (model_type, layers):
        return [f"final/config.json: {fc.get('model_type')}, {fc.get('num_hidden_layers')} "
                f"layers"]
    return []


def train_13b_ds(ckpt: str, tree: str, out: str, device: str = "cuda") -> dict:
    """17a: VCoder-DS stage 3 as ``vcoder_ds_train.sh`` runs it, from the
    13B directory ``ckpt`` over the COST tree ``tree``: B=4,
    ``--model-max-length 2048``, ``TRAIN_STEPS_13B`` steps. Gates: finite
    losses; non-zero seg-projector and ``vcoder_lm_emb`` gradients and an
    exactly zero depth-projector gradient every step; per step 2L K1, L K6
    and 23 ViT blocks and no other kernel; ``final/config.json`` naming
    ``vcoder_ds_llava`` with the directory's L layers; the weight files'
    headers; the peak at most ``PEAK_ESTIMATE_GIB``; the kernel route's trainable
    gradients on the trained tree within ``GRAD_ROUTE_REL_L2`` of the plain
    route's on one sample."""
    from vcoder_tpu_torch.train import vcoder_ds_train

    with open(os.path.join(ckpt, "config.json")) as f:
        L = json.load(f)["num_hidden_layers"]
    argv = ["--model-path", ckpt, "--seg-data-path", tree, "--depth-data-path", tree,
            "--image-folder", tree, "--output-dir", out, "--per-device-train-batch-size", "4",
            "--model-max-length", "2048", "--max-steps", str(TRAIN_STEPS_13B), "--device", device]
    res = _drive_stage(vcoder_ds_train.main, argv, out, TRAIN_STEPS_13B, device)
    trainer, records, metrics = res["trainer"], res["records"], res["metrics"]
    read = _step_readings(res, 4)
    bad = _final_gate(res, "vcoder_ds_llava", L)
    if len(metrics) != TRAIN_STEPS_13B or len(records) != TRAIN_STEPS_13B or not all(
            np.isfinite([m["loss"], m["grad_norm"]]).all() for m in metrics):
        bad.append(f"{len(metrics)} metrics lines, {len(records)} steps, or a non-finite loss")
    for i, r in enumerate(records):
        seg = max(v for k, v in r["norms"].items() if k.startswith("seg_projector/"))
        depth = [v for k, v in r["norms"].items() if k.startswith("depth_projector/")]
        if not (seg > 0 and r["norms"]["vcoder_lm_emb"] > 0) or any(depth):
            bad.append(f"step {i + 1}: seg_projector {seg}, vcoder_lm_emb "
                       f"{r['norms']['vcoder_lm_emb']}, depth_projector {depth}")
    log(f"  17a: peak {res['peak'] / 2**30:.2f} GiB allocated (estimated {PEAK_ESTIMATE_GIB})")
    if device == "cuda" and not res["peak"] <= PEAK_ESTIMATE_GIB * 2**30:
        bad.append(f"peak {res['peak'] / 2**30:.2f} GiB over the estimate {PEAK_ESTIMATE_GIB}")
    if bad:
        raise SystemExit("17a: " + "; ".join(bad))
    train_launch_gate("17a", res["counts"], L, TRAIN_STEPS_13B)
    t0 = time.perf_counter()
    r = route_agreement(trainer.cfg, trainer.params, DSSamples(1, trainer.cfg.vision.image_size),
                        read["T"], trainer.args.stage, device=device)
    route_s = time.perf_counter() - t0
    log(f"  17a: kernel vs plain route on one sample at T={read['T']}: loss "
        f"{r['loss_kernel']:.5f} vs {r['loss_plain']:.5f}, trainable gradients rel L2 "
        f"{r['rel']:.3e} (bound {GRAD_ROUTE_REL_L2}) per leaf "
        f"{json.dumps({k: round(v, 4) for k, v in r['per_leaf'].items()})}")
    if not r["rel"] <= GRAD_ROUTE_REL_L2:
        raise SystemExit("17a: kernel route gradients disagree with the plain route")
    return dict(read, counts=res["counts"], peak_gib=res["peak"] / 2**30,
                load_s=res["load_s"], run_stage_s=res["wall"], route_s=route_s,
                route_rel_l2=r["rel"], files_gib=res["sizes"])


def _frozen_digest(params, device: str) -> str:
    """Every bit of two frozen leaves: the decoder's q_proj (under its
    adapter) and the tower's fc1."""
    q = params["lm"]["layers"]["q_proj"]
    return bits_digest({"q_proj": getattr(q, "base", q),
                        "fc1": params["vision_tower"]["layers"]["fc1"]}, device)


def _it_lora_gates(res: dict, accum: int, layers: int, before: str, device: str) -> list:
    """17b's gates on the micro-batches' gradients, the frozen leaves and
    the piped adapters and ``final/``."""
    cfg, records, metrics = res["trainer"].cfg, res["records"], res["metrics"]
    micro = IT_LORA_UPDATES * accum
    bad = _final_gate(res, "vcoder_it_llava", layers)
    if len(metrics) != micro or len(records) != micro or not all(
            np.isfinite([m["loss"], m["grad_norm"]]).all() for m in metrics):
        bad.append(f"{len(metrics)} metrics lines, {len(records)} micro-batches, or a "
                   f"non-finite loss")
    norms = [r["norms"] for r in records]
    a_keys = sorted(k for k in norms[0] if k.endswith("/a"))
    b_keys = sorted(k for k in norms[0] if k.endswith("/b"))
    if len(a_keys) != len(LORA_TARGETS) or len(b_keys) != len(LORA_TARGETS):
        bad.append(f"trainable adapters {a_keys} {b_keys}")
    for i, n in enumerate(norms):
        update = i // accum + 1
        seg = max(v for k, v in n.items() if k.startswith("seg_projector/"))
        if not (seg > 0 and all(n[k] > 0 for k in b_keys)):
            bad.append(f"micro-batch {i + 1}: a zero b or seg_projector gradient")
        a_moving = [n[k] > 0 for k in a_keys]
        if (update <= 2 and any(a_moving)) or (update == IT_LORA_UPDATES and not all(a_moving)):
            bad.append(f"micro-batch {i + 1} (update {update}): a gradients "
                       f"{[n[k] for k in a_keys]}")
    if _frozen_digest(res["trainer"].params, device) != before:
        bad.append("q_proj or the tower's fc1 changed")
    hdr = res["piped"]["adapters.safetensors"]["header"]
    for name, (din, dout) in lora_dims(cfg.text).items():
        for field, shape in (("a", [layers, din, 128]), ("b", [layers, 128, dout])):
            got = hdr.get(f"lm/layers/{name}/{field}", {}).get("shape")
            if got != shape:
                bad.append(f"adapters.safetensors lm/layers/{name}/{field}: {got}, want {shape}")
    if not all(any(k.startswith(f"{p}/") for k in hdr) for p in ("seg_projector", "mm_projector")):
        bad.append("adapters.safetensors lacks a projector")
    final = res["piped"]["final/model.safetensors"]["header"]
    q = final.get("model.layers.0.self_attn.q_proj.weight", {}).get("shape")
    if q != [cfg.text.num_heads * cfg.text.head_dim, cfg.text.hidden_size] or any(
            "lora" in k or k.endswith((".a", ".b")) for k in final):
        bad.append(f"final/ is not a merged checkpoint (q_proj {q})")
    return bad


def train_13b_it_lora(ckpt: str, tree: str, tmp: str, device: str = "cuda",
                      batch: int = IT_LORA_BATCH) -> dict:
    """17b: the VCoder-IT LoRA stage as ``vcoder_it_lora.sh`` runs it
    (``IT_LORA_FLAGS``), from a llava-typed directory beside ``ckpt``
    (:func:`write_llava_dir`: a hard link) over the COST tree's seg entries:
    B=``batch`` x ``--gradient-accumulation-steps`` = ``IT_LORA_ROWS``,
    ``IT_LORA_UPDATES`` updates. Gates (:func:`_it_lora_gates`): finite
    losses; every ``b`` and the seg projector's gradient non-zero on every
    micro-batch; every ``a`` gradient exactly 0 through the first two
    updates (b is 0 until the second moves it) and non-zero in the last;
    q_proj and the tower's fc1 kept bit for bit; ``adapters.safetensors``
    holding ``a`` [L, in, 128] and ``b`` [L, 128, out] of the seven decoder
    products and the projectors; ``final/`` merged, a ``vcoder_it_llava``
    of L layers; per micro-batch 2L K1, L K6 and 23 ViT blocks and no other
    kernel; the merge's peak over what it starts from at most the merged
    weights plus ``MERGE_SLACK_GIB``."""
    from vcoder_tpu_torch.train import vcoder_it

    base = os.path.join(tmp, LLAVA_DIR_13B)
    write_llava_dir(base, ckpt)
    with open(os.path.join(base, "config.json")) as f:
        L = json.load(f)["num_hidden_layers"]
    accum = IT_LORA_ROWS // batch
    micro = IT_LORA_UPDATES * accum
    out = os.path.join(tmp, "it_lora")
    argv = ["--model-path", base, "--seg-data-path", tree, "--image-folder", tree,
            "--output-dir", out, "--per-device-train-batch-size", str(batch),
            "--gradient-accumulation-steps", str(accum), "--model-max-length", "2048",
            "--num-train-epochs", "8", "--max-steps", str(micro), "--device", device,
            *IT_LORA_FLAGS]
    before, merge = {}, {}
    with measured_merge(merge, device):
        res = _drive_stage(vcoder_it.main, argv, out, micro, device,
                           first=lambda p: before.update(digest=_frozen_digest(p, device)))
    read = _step_readings(res, batch)
    bad = _it_lora_gates(res, accum, L, before.get("digest"), device)
    gib = 2**30
    bound = merge.get("merged", 0) + MERGE_SLACK_GIB * gib
    log(f"  17b: merge {merge.get('s', float('nan')):.1f} s, {merge.get('merged', 0) / gib:.2f} "
        f"GiB merged, {merge.get('held', float('nan')) / gib:.2f} GiB held before it, its peak "
        f"{merge.get('over', float('nan')) / gib:.2f} GiB over that (bound {bound / gib:.2f})")
    if "over" not in merge or merge["over"] > bound:
        bad.append(f"the merge's peak {merge.get('over')} B over what it started from "
                   f"exceeds {bound} B")
    if bad:
        raise SystemExit("17b: " + "; ".join(bad))
    train_launch_gate("17b", res["counts"], L, micro)
    return dict(read, B=batch, accum=accum, micro=micro, counts=res["counts"],
                peak_gib=merge.get("train_peak", res["peak"]) / gib, merge_s=merge["s"],
                merge_over_gib=merge["over"] / gib, merged_gib=merge["merged"] / gib,
                held_gib=merge["held"] / gib, load_s=res["load_s"], run_stage_s=res["wall"],
                files_gib=res["sizes"])


def phase_train_13b(ckpt: str, device: str = "cuda") -> dict:
    """Phase 17: VCoder-DS-13B training from phase 16's 13B directory
    ``ckpt``, over :func:`make_train_tree`'s COST tree, no weight file
    written (the stages' weight files go through pipes): 17a
    (:func:`train_13b_ds`), then 17b (:func:`train_13b_it_lora`). Logs a
    ``phase17: {...}`` line; returns the launch totals."""
    import gc

    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="vcoder_train_13b_")
    try:
        tree = os.path.join(tmp, "cost")
        make_train_tree(tree)
        log(f"  17a: vcoder_ds_train from {os.path.basename(ckpt)}, B=4, {TRAIN_STEPS_13B} steps "
            f"(peak estimated {PEAK_ESTIMATE_GIB} GiB)")
        a = train_13b_ds(ckpt, tree, os.path.join(tmp, "ds"), device)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        log(f"  17b: vcoder_it --lora-enable from {LLAVA_DIR_13B} (a hard link), B="
            f"{IT_LORA_BATCH} x {IT_LORA_ROWS // IT_LORA_BATCH} accumulated, {IT_LORA_UPDATES} "
            f"updates")
        b = train_13b_it_lora(ckpt, tree, tmp, device)
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"phase17: {json.dumps({'17a': a, '17b': b, 'phase_s': time.perf_counter() - t_phase})}")
    return {k: a["counts"][k] + b["counts"][k] for k in ("flash", "flash_bwd", "vit")}


# ---------------------------------------------------------------------------
# Phase 18: the 13B full-LLM stage with the Adam moments offloaded, in phase
# 16's 13B directory (alone: scripts/phase18.py; over four cards:
# scripts/phase18.py --mesh)
# ---------------------------------------------------------------------------

# Three steps, not phase 14's four: the cut that keeps the whole run inside
# its time (PERF.md section 4).
FULL_STEPS_13B = 3
# The largest of 4, 2, 1 whose offloaded 13B step fits an 80 GB card, as
# ``scripts/phase18.py --find-full-batch`` finds it (PERF.md).
FULL_BATCH_13B = 2
# One row's saved products at T=2048 under remat "dots", from phase 14 at
# 7B: its B=4 peak of 50.56 GiB less 13.15 GiB of weights, 12.59 of
# gradients and the largest gradient's per-layer transient (2.69) leaves
# 5.53 GiB a row. A row's products scale with ``_row_units``.
ROW_GIB_7B = 5.53
# Headroom of a peak estimate over its reckoning: the loss's f32 logits and
# what the allocator rounds.
PEAK_SLACK_GIB = 2.0
# Under a mesh each layer's weights are gathered whole for the forward and
# again for its recomputation, and their gradients come whole before the
# reduce-scatter: at most this many copies of one layer's weights at once.
GATHERED_LAYER_COPIES = 4
# Four cards, mesh (1, 4, 1): the recipe's ZeRO-3 + offload layout
# (scripts/zero3_offload.json), every rank its quarter of the weights,
# gradients and moments. The per-device batch is the largest of these that
# runs.
MESH_FSDP = 4
MESH_BATCHES = (4, 2, 1)
MESH_STEPS = 4


def _row_units(text) -> int:
    """A decoder's saved products per token under remat "dots": every
    layer's q, k, v and o outputs (4 x hidden), gate and up (2 x
    intermediate) and down (hidden)."""
    return text.num_layers * (5 * text.hidden_size + 2 * text.intermediate_size)


def _local_shape(path: str, shape, fsdp: int) -> tuple:
    """This rank's shard of a leaf over a mesh (1, ``fsdp``, 1), by
    ``parallel/sharding.py``'s rules (a dimension ``fsdp`` does not divide
    stays whole, as ``_shrink_to_fit`` has it)."""
    from vcoder_tpu_torch.parallel.sharding import spec_for_path

    spec = spec_for_path(path)
    if len(spec) > len(shape):
        return tuple(shape)
    out = []
    for dim, names in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        names = (names,) if isinstance(names, str) else (names or ())
        out.append(dim // fsdp if "fsdp" in names and dim % fsdp == 0 else dim)
    return tuple(out)


def full_stage_reckoning(cfg, fsdp: int = 1) -> dict:
    """The full stage's memory at ``cfg`` (a llava config, bf16 weights) on
    one rank of a mesh (1, ``fsdp``, 1), reckoned from the leaves' shapes
    alone, in bytes: ``weights`` (the whole tree, the tower included),
    ``grads`` (every trainable leaf's gradient: ``torch.autograd.grad`` holds
    them all at once), ``moments`` (Adam's ``mu`` and ``nu`` in the
    parameters' dtype, as ``AdamW.init`` makes them: 4 bytes a trainable
    parameter), ``holding`` (what PyTorch's caching host allocator takes to
    pin them: each ``torch.empty(..., pin_memory=True)`` rounded up to a
    power of two), ``largest`` (the largest gradient, made whole at each
    layer's backward), ``layer`` (one decoder layer's weights, whole),
    ``resident`` (weights, gradients and moments on the card at once, before
    any activation) and ``row`` (one row's saved products at T=2048, scaled
    from 7B's ``ROW_GIB_7B``); ``trainable`` counts the trainable
    parameters."""
    import torch

    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.models.vcoder import build_vcoder_params
    from vcoder_tpu_torch.train.step import trainable_leaves
    from vcoder_tpu_torch.tree import named_leaves

    meta = build_vcoder_params(cfg, torch.Generator(), dtype=torch.bfloat16, device="meta")
    train = trainable_leaves(meta, "full")
    local = {p: int(np.prod(_local_shape(p, t.shape, fsdp))) * t.element_size()
             for p, t in named_leaves(meta)}
    t7 = VCoderConfig.standard("llava", "7b").text
    rk = dict(weights=sum(local.values()), grads=sum(local[p] for p in train),
              moments=2 * sum(local[p] for p in train),
              holding=2 * sum(1 << (local[p] - 1).bit_length() for p in train),
              largest=max(local[p] for p in train),
              layer=sum(t[0].numel() * t.element_size() for t in meta["lm"]["layers"].values()),
              row=ROW_GIB_7B * 2**30 * _row_units(cfg.text) / _row_units(t7),
              trainable=sum(t.numel() for t in train.values()))
    rk["resident"] = rk["weights"] + rk["grads"] + rk["moments"]
    return rk


def full_peak_estimate_gib(rk: dict, batch: int, fsdp: int = 1) -> float:
    """The offloaded step's peak of allocated device memory at ``batch``
    rows a device, from :func:`full_stage_reckoning`'s ``rk``: the weights,
    every gradient, the largest gradient's per-layer transient and the rows'
    saved products, all held when the backward starts, plus
    ``PEAK_SLACK_GIB``; under a mesh (``fsdp`` > 1) also
    ``GATHERED_LAYER_COPIES`` whole layers."""
    gathered = GATHERED_LAYER_COPIES * rk["layer"] if fsdp > 1 else 0
    return ((rk["weights"] + rk["grads"] + rk["largest"] + gathered + batch * rk["row"]) / 2**30
            + PEAK_SLACK_GIB)


def _meminfo_gib(field: str = "MemTotal") -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1]) / 2**20
    return float("nan")


def _host_empty_cache() -> None:
    """Hand the caching host allocator's free pinned blocks back to the
    system."""
    import torch

    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None and torch.cuda.is_available():
        empty()


def _host_holding() -> dict:
    """The caching host allocator's byte counters (empty without CUDA)."""
    import torch

    if not (torch.cuda.is_available() and hasattr(torch.cuda, "host_memory_stats")):
        return {}
    return {k: v for k, v in torch.cuda.host_memory_stats().items() if "bytes" in k}


@contextlib.contextmanager
def timed_pinning(laps: dict):
    """The seconds of the ``Placement.zeros`` calls made inside the block
    (the offloaded state's host zeros, pinned on a card) summed into
    ``laps["pin_s"]``, and the host RSS just before the first and just
    after the last (``rss_before_pin``, ``rss_after_pin``)."""
    from vcoder_tpu_torch.parallel import sharding

    zeros = sharding.Placement.zeros

    def timed(self, t):
        laps.setdefault("rss_before_pin", _rss_gib())
        t0 = time.perf_counter()
        try:
            return zeros(self, t)
        finally:
            laps["pin_s"] = laps.get("pin_s", 0.0) + time.perf_counter() - t0
            laps["rss_after_pin"] = _rss_gib()

    sharding.Placement.zeros = timed
    try:
        yield laps
    finally:
        sharding.Placement.zeros = zeros


def _host_state(trainer, device) -> tuple:
    """The offloaded state's (this rank's) shaped leaves' bytes, and
    whether every one lies in host memory (pinned on a card) with ``count``
    on the device. Holds no reference to the state: its pinned blocks go
    once the trainer releases it."""
    import torch

    dev = torch.device(device).type
    state = _locals(trainer.opt_state)
    host = {k: t for k, t in state.items() if t.ndim}
    placed = (all(t.device.type == "cpu" and (t.is_pinned() or dev != "cuda")
                  for t in host.values())
              and state["count"].device.type == dev
              and set(host) == {k for k in state if k != "count"})
    return sum(t.numel() * t.element_size() for t in host.values()), placed


def _host_reading(laps: dict, holding: int) -> dict:
    """Host memory once the state is pinned: RSS, whether the pinned pages
    show in it (RSS grew by at least half the holding while pinning), the
    memory in use counting each byte once (RSS, plus the holding when it
    does not show there) and the machine's (``/proc/meminfo``)."""
    rss = _rss_gib()
    grew = laps.get("rss_after_pin", rss) - laps.get("rss_before_pin", rss)
    in_rss = bool(grew >= 0.5 * holding / 2**30)
    return dict(rss_gib=round(rss, 2), rss_grew_gib=round(grew, 2), pinned_in_rss=in_rss,
                used_gib=round(rss + (0.0 if in_rss else holding / 2**30), 2),
                total_gib=round(_meminfo_gib(), 2))


def _stage_argv(base: str, data: str, out: str, batch: int, steps: int, device: str) -> list:
    """``finetune.sh``'s flags for ``train.train``: the full stage with the
    moments offloaded, lr 2e-5, T up to 2048; ``steps`` steps of ``batch``
    rows a device and one step checkpoint (the last)."""
    here = os.path.dirname(os.path.abspath(__file__))
    return ["--stage", "full", "--model-path", base, "--data-path", data, "--image-folder", here,
            "--output-dir", out, "--learning-rate", "2e-5", "--num-train-epochs", "1",
            "--per-device-train-batch-size", str(batch), "--model-max-length", "2048",
            "--max-steps", str(steps), "--save-steps", str(steps), "--offload-opt-state",
            "--device", device]


def full_stage_cli(label: str, ckpt: str, tmp: str, name: str, batch: int, steps: int,
                   device: str, turns: int) -> tuple:
    """The LLaVA full finetune as ``scripts/v1_5/train_torch/finetune.sh``
    runs it with ``--offload-opt-state``, from ``tmp/name``, a llava-typed
    hard link of the VCoder-DS directory ``ckpt`` (:func:`write_llava_dir`),
    over :func:`make_llava_json`'s conversations of ``turns`` turns:
    ``train.train``'s ``main`` in this process (so the launch counters can
    be read), B=``batch``, ``steps`` steps (:func:`_stage_argv`), every
    weight file through pipes (:func:`piped_weights`). Gates: finite losses;
    non-zero ``lm/`` and ``mm_projector`` gradient norms every step; per step
    2L K1, L K6 and 23 ViT blocks and no other kernel; every shaped moment
    in host memory (pinned on a card) and ``count`` on the device; the
    state's bytes equal to :func:`full_stage_reckoning`'s moments and (on a
    card) the host allocator's holding within 1% of its rounded holding;
    host memory in use below the machine's; (on a card) the peak of
    allocated device memory at most :func:`full_peak_estimate_gib`; the
    pipes' headers and byte counts; ``final/config.json`` a llava of L
    layers. Logs each step (ms, valid tokens/s, its update pass), the
    seconds loading and pinning, each piped file's seconds, and the resident
    bytes reckoned for the card. Returns the trainer (its state still held)
    and the readings; the caller releases the state."""
    import torch

    from vcoder_tpu_torch.config import VCoderConfig
    from vcoder_tpu_torch.train import train as train_mod

    cuda = torch.device(device).type == "cuda"
    gib = 2**30
    base = os.path.join(tmp, name)
    write_llava_dir(base, ckpt)
    with open(os.path.join(base, "config.json")) as f:
        cfg = VCoderConfig.from_hf_config(json.load(f))
    L = cfg.text.num_layers
    rk = full_stage_reckoning(cfg)
    estimate = full_peak_estimate_gib(rk, batch)
    log(f"  {label}: train.train --stage full --offload-opt-state from {name} (a hard link), "
        f"B={batch}, {steps} steps; reckoned: {rk['trainable'] / 1e9:.4g} B trainable, moments "
        f"{rk['moments'] / gib:.2f} GiB (pinned holding {rk['holding'] / 1e9:.2f} GB), peak "
        f"estimate {estimate:.2f} GiB; resident, the weights, gradients and moments alone would "
        f"take {rk['resident'] / gib:.2f} GiB of the card (reckoned, not run)")
    data, out = os.path.join(tmp, "llava.json"), os.path.join(tmp, "out")
    make_llava_json(data, turns=turns)
    laps = {}
    with timed_pinning(laps):
        res = _drive_stage(train_mod.main, _stage_argv(base, data, out, batch, steps, device),
                           out, steps, device)
    trainer, records, metrics, counts = (res[k] for k in ("trainer", "records", "metrics",
                                                          "counts"))
    pinned, placed = _host_state(trainer, device)
    stats = _host_holding()
    holding = stats.get("allocated_bytes.current", 0)
    mem = _host_reading(laps, holding)
    for m, r in zip(metrics, records):
        lm = max(v for k, v in r["norms"].items() if k.startswith("lm/"))
        mm = max(v for k, v in r["norms"].items() if k.startswith("mm_projector/"))
        log(f"  full stage step {m['step']}: T={r['T']} B={batch}, {r['tokens']} tokens, "
            f"{r['ms']:.1f} ms, {r['tokens'] / r['ms'] * 1e3:.0f} tokens/s, loss "
            f"{m['loss']:.4f}, grad_norm {m['grad_norm']:.4f}, lm/ grad norm (largest leaf) "
            f"{lm:.4g}, mm_projector {mm:.4g}; {_copies_line(r)}")
    bad = _final_gate(res, "llava", L)
    if len(metrics) != steps or not all(
            np.isfinite([m["loss"], m["grad_norm"]]).all() for m in metrics):
        bad.append(f"{len(metrics)} metrics lines or a non-finite loss")
    if not placed:
        bad.append("a shaped moment off the (pinned) host, or count off the device")
    if pinned != rk["moments"]:
        bad.append(f"the state holds {pinned} B, the reckoned moments {rk['moments']} B")
    if cuda and abs(holding - rk["holding"]) > 0.01 * rk["holding"]:
        bad.append(f"the host allocator holds {holding} B, reckoned {rk['holding']} B")
    if not mem["used_gib"] < mem["total_gib"]:
        bad.append(f"host memory in use {mem['used_gib']} GiB, the machine's "
                   f"{mem['total_gib']}")
    if cuda and not res["peak"] <= estimate * gib:
        bad.append(f"peak {res['peak'] / gib:.2f} GiB over the estimate {estimate:.2f}")
    ms_p50 = float(np.median([r["ms"] for r in records[1:]]))
    tok_s = float(np.median([r["tokens"] / r["ms"] * 1e3 for r in records[1:]]))
    log(f"  {label}: peak {res['peak'] / gib:.2f} GiB allocated (estimate {estimate:.2f}); "
        f"state {pinned / gib:.2f} GiB in {'pinned ' if cuda else ''}host memory (reckoned "
        f"{rk['moments'] / gib:.2f}), host allocator {json.dumps(stats)} (reckoned holding "
        f"{rk['holding']} B), pinning {laps.get('pin_s', float('nan')):.1f} s; host "
        f"{json.dumps(mem)}; load {res['load_s']:.1f} s, train.main {res['wall']:.1f} s (load, "
        f"pinning, {steps} steps, checkpoint, adapters, final/); steps 2-{steps} p50 "
        f"{ms_p50:.1f} ms, {tok_s:.0f} valid tokens/s; written through pipes (GiB) "
        f"{json.dumps(res['sizes'])} in (s) "
        f"{json.dumps({k: round(v['s'], 1) for k, v in res['piped'].items()})}; launches "
        f"{json.dumps(counts)}; final/config.json model_type "
        f"{res['final_config'].get('model_type')}")
    if bad:
        raise SystemExit(f"{label}: " + "; ".join(bad))
    _train_gate(label, records, counts, steps, L)
    got = dict(B=batch, T=records[0]["T"], losses=[m["loss"] for m in metrics],
               step_ms_p50=ms_p50, tokens_s=tok_s, peak_gib=res["peak"] / gib,
               estimate_gib=estimate, pinned_gib=pinned / gib, holding=holding,
               reckoned_holding=rk["holding"], host=mem, pin_s=laps.get("pin_s"),
               load_s=res["load_s"], train_main_s=res["wall"],
               update_ms=[round(r["copies"]["wall"], 1) for r in records if r.get("copies")],
               files_gib=res["sizes"], counts=counts)
    return trainer, got


def phase_full_13b(ckpt: str, device: str = "cuda", batch: int = FULL_BATCH_13B,
                   turns: int = LLAVA_TURNS) -> dict:
    """Phase 18: the LLaVA full finetune at 13B, :func:`full_stage_cli`
    from phase 16's 13B directory ``ckpt`` at B=``batch``,
    ``FULL_STEPS_13B`` steps, with its gates (the card cannot hold the
    state resident, so no A/B). Once the state is released, its pinned
    blocks go back to the system: the host allocator must hold under 1% of
    them after (the phases after this one, the mesh's ranks, need the host
    memory). Returns the launch counts and the readings."""
    import gc

    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="vcoder_full_13b_")
    try:
        trainer, got = full_stage_cli("18", ckpt, tmp, LLAVA_DIR_13B, batch, FULL_STEPS_13B,
                                      device, turns)
        trainer.release_state()
        del trainer
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
            _host_empty_cache()  # the pinned blocks go back to the system
    got["held_after"] = _host_holding().get("allocated_bytes.current", 0)
    if got["held_after"] > 0.01 * got["reckoned_holding"]:
        raise SystemExit(f"18: the host allocator still holds {got['held_after']} B of pinned "
                         f"memory after the state was released")
    got["phase_s"] = time.perf_counter() - t_phase
    log(f"phase18: {json.dumps(got, default=float)}")
    return got


def full_mesh_reference(argv: list, world: int, micro: int, device: str = "cuda") -> dict:
    """Step 1 of the stage ``argv`` runs over ``world`` ranks, on one
    device: the global batch the ranks' sampler draws (``world`` x the
    per-device batch rows, padded to one bucket) through the loaded weights
    in micro-batches of ``micro`` rows, on the routes a mesh takes (the
    tower's unfused blocks, the flash route on each micro-batch's rows);
    each micro-batch's loss weighted by its share of the global batch's
    valid labels, as the ranks' loss weights their rows, and the gradients
    summed in f32 in host memory. Returns the loss, the global gradient norm
    and each trainable leaf's."""
    import gc

    import torch

    from vcoder_tpu_torch import builder
    from vcoder_tpu_torch.constants import IGNORE_INDEX
    from vcoder_tpu_torch.models import clip
    from vcoder_tpu_torch.models import vcoder as model_mod
    from vcoder_tpu_torch.train import drivers
    from vcoder_tpu_torch.train import train as train_mod
    from vcoder_tpu_torch.train.step import trainable_leaves
    from vcoder_tpu_torch.train.trainer import TrainArgs, epoch_batches

    args = train_mod.build_parser().parse_args(argv)
    tok, model, *_ = builder.load_pretrained_model(args.model_path, device=device)
    cfg, params = model.config, model.params
    targs = TrainArgs(per_device_train_batch_size=args.per_device_train_batch_size,
                      seed=args.seed, group_by_modality_length=args.group_by_modality_length,
                      dataloader_workers=0)
    dataset = drivers.build_dataset(args.stage, args, tok, cfg)
    with contextlib.closing(epoch_batches(cfg, dataset, targs, 0, device=device,
                                          world=world)) as batches:
        batch = next(batches)
    rows = batch["labels"].shape[0]
    count = (batch["labels"][:, 1:] != IGNORE_INDEX).sum()
    leaves = trainable_leaves(params, args.stage)
    acc = {p: torch.zeros(t.shape, dtype=torch.float32) for p, t in leaves.items()}
    loss_sum = 0.0
    clip.FUSED_BLOCKS = False
    try:
        for t in leaves.values():
            t.requires_grad_(True)
        for a in range(0, rows, micro):
            mb = {k: v[a * (v.shape[0] // rows):(a + micro) * (v.shape[0] // rows)]
                  if isinstance(v, torch.Tensor) and v.ndim else v for k, v in batch.items()}
            loss = model_mod.train_forward(params, cfg, mb, mb.get("images"),
                                           remat="dots" if args.gradient_checkpointing else False)
            part = loss * ((mb["labels"][:, 1:] != IGNORE_INDEX).sum() / count)
            grads = torch.autograd.grad(part, list(leaves.values()))
            loss_sum += float(part.detach())
            for p, g in zip(leaves, grads):
                acc[p].add_(g.cpu())
            del loss, part, grads
    finally:
        clip.FUSED_BLOCKS = True
        for t in leaves.values():
            t.requires_grad_(False)
    norms = {p: float(a.square().sum()) for p, a in acc.items()}
    out = dict(loss=loss_sum, grad_norm=float(np.sqrt(sum(norms.values()))),
               norms={p: float(np.sqrt(v)) for p, v in norms.items()}, rows=rows,
               T=int(batch["safe_ids"].shape[1]), tokens=int(batch["attn_mask"].sum()))
    del model, params, leaves, acc, batch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def full_mesh_rank(rank: int, world: int, argv: list, piped: bool = True) -> dict:
    """One rank of the full stage over a mesh (``scripts/phase18.py
    --mesh``, one NCCL rank a card; gloo ranks in the CPU tests): the stage
    ``argv`` (``train.train``'s flags with ``--mesh-*``) through its ``main``
    under the group, as a torchrun rank runs it, rank 0's weight files
    through pipes when ``piped``; then :func:`full_stage_ab` on this rank's
    shards (its launch gates on a card only: the CPU's routes
    launch nothing). Returns this rank's readings (no tensor)."""
    import torch

    from vcoder_tpu_torch.train import train as train_mod

    args = train_mod.build_parser().parse_args(argv)
    device, out, steps = args.device, args.output_dir, args.max_steps
    laps = {}
    with timed_pinning(laps):
        res = _drive_stage(train_mod.main, argv, out, steps, device, piped=piped and rank == 0,
                           outputs=rank == 0)
    trainer = res["trainer"]
    pinned, placed = _host_state(trainer, device)
    holding = _host_holding().get("allocated_bytes.current", 0)
    reading = dict(
        rank=rank, mesh=dict(trainer.mesh.shape), layers=trainer.cfg.text.num_layers,
        records=[{k: r[k] for k in ("ms", "T", "tokens", "loss", "grad_norm", "norms", "copies")
                  if k in r} for r in res["records"]],
        counts=res["counts"], peak=res["peak"], pinned=pinned, placed=placed, holding=holding,
        host=_host_reading(laps, holding), pin_s=laps.get("pin_s"), load_s=res["load_s"],
        wall=res["wall"], sizes=res["sizes"], final_config=res.get("final_config"),
        reckoned=full_stage_reckoning(trainer.cfg, trainer.mesh.shape["fsdp"]),
        device=str(trainer.device))
    del res
    with tempfile.TemporaryDirectory() as tmp:
        reading["ab"] = full_stage_ab(trainer, tmp, vit=0,
                                      launches=torch.device(device).type == "cuda")
    trainer.release_state()
    del trainer
    if torch.device(device).type == "cuda":
        _host_empty_cache()
    return reading


def full_mesh_gates(ranks: list, ref: dict, batch: int, steps: int) -> tuple:
    """The four-card run's gates over every rank's readings
    (:func:`full_mesh_rank`) against the one-device reference
    (:func:`full_mesh_reference`): every rank the same losses and gradient
    norms; step 1's loss within ``SHARDED_LOSS_REL`` and its global
    gradient norm within ``SHARDED_NORM_REL`` of the reference; per rank and
    step 2L K1, L K6, no ViT block (the tower runs its unfused blocks under a
    mesh) and no other kernel, and non-zero ``lm/`` and ``mm_projector``
    gradients; each rank's state in pinned host memory, its bytes its shards'
    (:func:`full_stage_reckoning` at the mesh's ``fsdp``: a quarter of the
    moments, the replicated norms and biases whole); each rank's peak at most
    its :func:`full_peak_estimate_gib`; rank 0's ``final/`` a llava of L
    layers; the host memory the ranks use below the machine's. Returns a
    summary and the failures."""
    bad = []
    r0 = ranks[0]
    L = r0["layers"]
    keys = lambda r: [(x["loss"], x["grad_norm"], x["norms"]) for x in r["records"]]  # noqa: E731
    for r in ranks[1:]:
        if keys(r) != keys(r0):
            bad.append(f"rank {r['rank']}'s losses or gradient norms differ from rank 0's")
    first = r0["records"][0] if r0["records"] else {}
    loss_rel = abs(first.get("loss", np.nan) - ref["loss"]) / abs(ref["loss"])
    norm_rel = abs(first.get("grad_norm", np.nan) - ref["grad_norm"]) / ref["grad_norm"]
    if not loss_rel <= SHARDED_LOSS_REL or not norm_rel <= SHARDED_NORM_REL:
        bad.append(f"step 1 loss {first.get('loss')} vs {ref['loss']} (rel {loss_rel:.3e}, bound "
                   f"{SHARDED_LOSS_REL}), grad norm {first.get('grad_norm')} vs "
                   f"{ref['grad_norm']} (rel {norm_rel:.3e}, bound {SHARDED_NORM_REL})")
    leaf_rel = {p: abs(first["norms"][p] - v) / v for p, v in ref["norms"].items() if v} \
        if first else {}
    used = 0.0
    for r in ranks:
        label = f"rank {r['rank']}"
        cuda = r["device"].startswith("cuda")
        try:
            _train_gate(label, r["records"], r["counts"], steps, L, vit=0)
        except SystemExit as e:
            bad.append(str(e))
        if not r["placed"]:
            bad.append(f"{label}: a shaped moment off the (pinned) host, or count off the device")
        if r["pinned"] != r["reckoned"]["moments"]:
            bad.append(f"{label}: state {r['pinned']} B, its shards' moments "
                       f"{r['reckoned']['moments']} B")
        estimate = full_peak_estimate_gib(r["reckoned"], batch, r["mesh"]["fsdp"])
        r["estimate_gib"] = estimate
        if cuda and not r["peak"] <= estimate * 2**30:
            bad.append(f"{label}: peak {r['peak'] / 2**30:.2f} GiB over its estimate "
                       f"{estimate:.2f}")
        used += r["host"]["used_gib"]
    fc = r0.get("final_config") or {}
    if (fc.get("model_type"), fc.get("num_hidden_layers")) != ("llava", L):
        bad.append(f"rank 0's final/config.json: {fc.get('model_type')}, "
                   f"{fc.get('num_hidden_layers')} layers")
    total = r0["host"]["total_gib"]
    if not used < total:
        bad.append(f"the ranks' host memory in use {used:.2f} GiB, the machine's {total}")
    # A rank's records count its own rows' tokens: the mesh's are their sum.
    ms = [x["ms"] for x in r0["records"][1:]] or [np.nan]
    tok = [sum(r["records"][i]["tokens"] for r in ranks) / r0["records"][i]["ms"] * 1e3
           for i in range(1, len(r0["records"]))] or [np.nan]
    summary = dict(
        B=batch, global_rows=ref["rows"], T=ref["T"], steps=steps,
        losses=[round(x["loss"], 5) for x in r0["records"]],
        step1=dict(loss=first.get("loss"), ref_loss=ref["loss"], loss_rel=loss_rel,
                   grad_norm=first.get("grad_norm"), ref_grad_norm=ref["grad_norm"],
                   norm_rel=norm_rel,
                   leaf_norm_rel_max=max(leaf_rel.items(), key=lambda kv: kv[1], default=None)),
        step_ms_p50=float(np.median(ms)), tokens_s_p50=float(np.median(tok)),
        update=[_copies_line(x) for x in r0["records"]],
        peak_gib=[round(r["peak"] / 2**30, 2) for r in ranks],
        estimate_gib=[round(r["estimate_gib"], 2) for r in ranks],
        state_gib=[round(r["pinned"] / 2**30, 3) for r in ranks],
        holding_gb=[round(r["holding"] / 1e9, 2) for r in ranks],
        host=[r["host"] for r in ranks], host_used_gib=round(used, 2),
        pin_s=[r["pin_s"] for r in ranks], load_s=[round(r["load_s"], 1) for r in ranks],
        train_main_s=[round(r["wall"], 1) for r in ranks], files_gib=r0["sizes"],
        ab=[{k: r["ab"][k] for k in ("peak_resident", "peak_offloaded", "ms", "moments")}
            for r in ranks],
        counts=[r["counts"] for r in ranks])
    return summary, bad


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
    laps = {}
    if "--faults" in sys.argv:
        return main_faults()

    def lap(name):
        laps[name] = round(time.perf_counter() - t_start - sum(laps.values()), 1)

    smi = phase_device()
    phase_build()
    lap("build")
    report: list = []
    phase_kernels(report)
    phase_paged_kernels(report)
    phase_fused_kernels(report)
    phase_quant_kernels(report)
    phase_kernels_13b(report)
    from vcoder_tpu_torch.config import VCoderConfig

    cfg7 = VCoderConfig.standard("vcoder_ds_llava", "7b")
    ds = DSSamples(20, cfg7.vision.image_size)
    layout = training_layout(cfg7, ds)
    lap("kernels")
    check_flash_training(report, layout)
    phase_flash_bwd_kernels(report, layout)
    check_training_13b(report, layout)
    lap("kernels_flash_bwd")
    cfg, params, model, tok = build_model()
    main_counts = phase_main_path(cfg, params, model, tok)
    lap("main_path")
    log("engines (phase 6): VCoder-DS-7B, max_batch 8, max_len 2048, page 64, EOS off")
    engine_counts, engine_a = phase_engines(cfg, params, model, tok)
    lap("engines")
    quant_counts = phase_quantized(cfg, params, tok)
    lap("quantized")
    log(f"training (phase 8): VCoder-DS-7B stage vcoder_ds, B=4, remat dots, {len(ds)} samples")
    train_counts = phase_training(cfg, params, ds, layout)["counts"]
    lap("training")
    log("fused append, fused MLP and multi-LoRA (phase 9): VCoder-DS-7B, the phase-4 weights")
    p9_counts = phase_fused_lora(cfg, params, model, tok, engine_a, main_counts["ttft_p50_ms"])
    lap("fused_lora")
    log("slot engine (phase 12): VCoder-DS-7B, max_batch 8, max_len 2048, engine A's traffic")
    p12 = phase_slot_engine(cfg, params, model, engine_a["preps"])
    lap("slot_engine")
    held = [params, model]  # phase 10 drops them once its checkpoint is written
    del params, model
    # Each entry's launches: the sum over the driven paths, each counted from
    # 0 just before it ran and read just after.
    launches = {
        "flash_fwd": (main_counts["flash_fwd"] + engine_counts["flash"] + quant_counts["flash"]
                      + train_counts["flash_fwd"] + p12["flash"]),
        "flash_fwd_train": train_counts["flash_fwd"],
        "flash_bwd": train_counts["flash_bwd"],
        "vit_block": (main_counts["vit_block"] + engine_counts["vit"] + quant_counts["vit"]
                      + train_counts["vit_block"] + p12["vit"]),
        "paged_attn_bf16": engine_counts["bf16"] + quant_counts["bf16"],
        "paged_attn_q8": engine_counts["q8"] + quant_counts["q8"],
        "paged_attn_k8": engine_counts["k8"] + quant_counts["k8"],
        "int4_matmul": quant_counts["int4"],
        "int8_mm": quant_counts["int8"],
        "int8_mm_scaled": quant_counts["int8_scaled"] + p12["int8_scaled"],
        "paged_attn_fused": p9_counts["fused"],
        "vit_mlp": p9_counts["mlp"],
    }
    phase_checkpoint()
    lap("checkpoint")
    tok10 = full_vocab_tokenizer(cfg)
    log("COST depth eval (phase 11, its inputs): VCoder-DS-7B bf16, the phase-4 weights")
    prep = cost_eval_prepare(cfg, held, tok10)
    lap("cost_prepare")
    log("surfaces (phase 10): VCoder-DS-7B bf16, the phase-4 weights and requests")
    p11, p13, p14 = {}, {}, {}

    def in_checkpoint_dir(d):
        p11.update(phase_cost_eval(d, prep, tok10))
        log("training stage from files (phase 13): vcoder_ds_train over a COST tree, B=4")
        p13.update(phase_train_stage(d))
        log(f"full-LLM stage (phase 14): train.train --stage full --offload-opt-state over "
            f"{LLAVA_DIR}, B={FULL_BATCH}")
        p14.update(phase_full_stage(d))

    p10 = phase_surfaces(cfg, held, tok10, main_counts["requests"], then=in_checkpoint_dir)
    lap("surfaces_cost_eval_train_stages")
    log("VCoder-DS-13B (phase 16): B=1 generate, engines A13, E13 and D13, a 13B directory; "
        "then 13B training in it (phases 17 and 18)")
    p17, p18 = {}, {}

    def in_13b_dir(d):
        p17.update(phase_train_13b(d))
        lap("13b_serving_and_training")
        log(f"13B full-LLM stage (phase 18): train.train --stage full --offload-opt-state over "
            f"{LLAVA_DIR_13B}, B={FULL_BATCH_13B}")
        p18.update(phase_full_13b(d))
        lap("13b_full_stage")

    p16 = phase_13b(p10["written_gib"], then=in_13b_dir)
    lap("13b_cleanup")
    p15 = phase_sharded()
    lap("sharded")
    launches["flash_fwd"] += p10["flash"] + p11["flash"] + p13["flash"] + p14["flash"]
    launches["flash_fwd_train"] += p13["flash"] + p14["flash"]
    launches["flash_bwd"] += p13["flash_bwd"] + p14["flash_bwd"]
    launches["vit_block"] += p10["vit"] + p11["vit"] + p13["vit"] + p14["vit"]
    launches["paged_attn_k8"] += p10["k8"] + p15["k8"]
    launches["flash_fwd"] += p15["flash"]
    launches["flash_fwd_train"] += p15["train_flash"]
    launches["flash_bwd"] += p15["flash_bwd"]
    launches["paged_attn_q8"] += p15["q8"]
    launches["paged_attn_bf16"] += p15["bf16"]
    launches["paged_attn_fused"] += p15["fused"]
    launches["int4_matmul"] += p15["int4"]
    launches["int8_mm"] += p15["int8"]
    launches["int8_mm_scaled"] += p15["int8_scaled"]
    launches["flash_fwd"] += p16["flash"]
    launches["vit_block"] += p16["vit"]
    launches["paged_attn_k8"] += p16["k8"]
    launches["paged_attn_q8"] += p16["q8"]
    launches["int4_matmul"] += p16["int4"]
    launches["int8_mm_scaled"] += p16["int8_scaled"]
    launches["flash_fwd"] += p17["flash"]
    launches["flash_fwd_train"] += p17["flash"]
    launches["flash_bwd"] += p17["flash_bwd"]
    launches["vit_block"] += p17["vit"]
    launches["flash_fwd"] += p18["counts"]["flash"]
    launches["flash_fwd_train"] += p18["counts"]["flash"]
    launches["flash_bwd"] += p18["counts"]["flash_bwd"]
    launches["vit_block"] += p18["counts"]["vit"]
    for entry in report:
        entry["launches"] = launches[entry["name"]]
    log(f"launches on the driven paths: {json.dumps(launches)}")
    log(f"wall {time.perf_counter() - t_start:.1f} s on {smi}; by phase (s) {json.dumps(laps)}")
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main_faults() -> int:
    """``--faults``: phase 3's K6 gates and phase 8's route gate against the
    faults of ``K6_FAULTS`` (no other phase; no result lines). Exits 0 when
    the K6 gates pass the sound kernel and fail every fault."""
    from vcoder_tpu_torch.config import VCoderConfig

    phase_device()
    phase_build()
    cfg7 = VCoderConfig.standard("vcoder_ds_llava", "7b")
    ds = DSSamples(20, cfg7.vision.image_size)
    caught = phase_k6_faults(training_layout(cfg7, ds), ds)
    log(f"K6 gates {'caught every planted fault' if caught else 'MISSED a planted fault'}")
    return 0 if caught else 1


if __name__ == "__main__":
    sys.exit(main())
