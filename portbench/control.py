"""The readings the limits of ``correct`` are set from, at a cell's own size
on the card: the control (a precision below the configuration's bf16) and
the faults, on several seeds. The benchmark's runs do not run this.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 [--seconds S]

* Training cells: the reference's first steps in float32 against the same
  reference with float8 (e4m3) products (the control: the program has no
  lower-precision training path), and against the reference over half of
  each batch, the mean taken over the rest (a fault). A step that leaves
  the state unchanged reads 1 by ``change_gap``'s measure and needs no run.
* Serving cells: a window of ``--seconds`` at the cell's own load, long
  enough to finish the mix's longest requests; then, over the same sample
  of finished requests as a run compares, ``served_gap`` of the program's
  tokens (a sound reading), of the tokens the program's own int8 path puts
  first (the control: the weights quantized by the port's
  ``quantize_params``, the prompt and served tokens run through its
  cache-free forward, W8A8 at these lengths), and of those the float8
  reference puts first.

One JSON line per seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def training(cell, seed, device, base=None):
    from portbench import check, drive, spec, weights
    from portbench.reference import model as ref_model
    from portbench.reference import train as ref_train

    base = spec.HERE if base is None else base
    cfg = spec.config(cell["config"], base / "configs")
    mix = spec.mix(cell["traffic"], base / "traffic")
    d, rec = spec.dims(cfg), cell["recipe"]
    ref_model.exact_math()
    w = weights.make(d, seed, device)
    paths = weights.trainable_paths(w)
    batches = check.train_rows(cfg, mix, seed, device, drive.first_rows(cell, cfg, mix, seed))
    out = {}
    t = time.perf_counter()
    ref = ref_train.run_steps(w, d, paths, batches, rec)
    out["reference_s"] = time.perf_counter() - t
    ctrl = ref_train.run_steps(w, d, paths, batches, rec, mode="fp8")
    out["fp8"], _ = check.train_gaps(ctrl, ref)
    half = [rows[: len(rows) // 2] for rows in batches]
    out["half_batch"], out["counted"] = check.train_gaps(
        ref_train.run_steps(w, d, paths, half, rec), ref)
    out["losses"] = ref["losses"]
    return out


def int8_logits(w, cfg, rows, device):
    """The program's int8 path over each (prompt, served tokens, pictures):
    its cache-free forward, teacher-forced, the logits at each served
    position."""
    import torch
    from vcoder_tpu_torch.models import llama as llama_mod
    from vcoder_tpu_torch.models import vcoder as model_mod
    from vcoder_tpu_torch.multimodal import build_splice_plan
    from vcoder_tpu_torch.quant import quantize_params

    from portbench import spec

    mcfg = spec.model_config(cfg)
    quantize_params(w, bits=8)
    out = []
    with torch.no_grad():
        for ids, served, px in rows:
            prompt = build_splice_plan([list(ids)], num_patches=mcfg.vision.num_patches,
                                       ds_mode=True, has_seg=True, has_depth=True,
                                       is_depth_zero=[False], pad_multiple=1)
            full = build_splice_plan([list(ids) + list(served[:-1])],
                                     num_patches=mcfg.vision.num_patches, ds_mode=True,
                                     has_seg=True, has_depth=True, is_depth_zero=[False],
                                     pad_multiple=1)
            a = model_mod.plan_to_arrays(full, device)
            vis = model_mod.encode_vision(w, mcfg, px[0:1], px[1:2], px[2:3])
            emb = model_mod.assemble_embeddings(w, mcfg, a["safe_ids"], a["is_text"],
                                                a["vis_idx"], vis, use_vcoder_emb=True)
            hidden, _ = llama_mod.llama_forward(w["lm"], mcfg.text, emb,
                                                attn_mask=a["attn_mask"],
                                                position_ids=a["position_ids"])
            P = int(prompt.seq_lens[0])
            out.append(llama_mod.lm_head(w["lm"], hidden[:, P - 1:])[0].float())
    return out


def serving(cell, seed, device, seconds, base=None, bench=None):
    from portbench import check, run, spec, weights

    base = spec.HERE if base is None else base
    cfg = spec.config(cell["config"], base / "configs")
    mix = spec.mix(cell["traffic"], base / "traffic")
    d = spec.dims(cfg)
    result, r = run.execute(cell["name"], seed, seconds, False, device,
                            t_start=time.perf_counter(), base=base, bench=bench)
    finished = {rid: s for rid, s in r.served.items() if s.done}
    pick = check.sample_requests(finished, mix, seed)
    rows = check.served_rows(finished, pick, mix, seed, d, device)
    out = {"program": result["check"], "correct": result["correct"],
           "metrics": result["metrics"], "requests": len(rows),
           "tokens": sum(len(x[1]) for x in rows)}
    w = weights.make(d, seed, device)
    ref = check.reference_logits(w, d, rows)
    out["program_again"] = check.gaps(ref, [x[1] for x in rows])
    out["int8"] = check.gaps(ref, [lg.argmax(-1) for lg in int8_logits(w, cfg, rows, device)])
    del w
    w = weights.make(d, seed, device)
    fp8 = check.reference_logits(w, d, rows, mode="fp8")
    out["fp8"] = check.gaps(ref, [lg.argmax(-1) for lg in fp8])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    a = p.parse_args(argv)
    import torch

    from portbench import run, spec

    run.cache_dirs(ROOT)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = spec.cell(a.workload)
    kind = spec.mix(cell["traffic"])["kind"]
    for seed in a.seeds:
        out = training(cell, seed, device) if kind == "train" else serving(
            cell, seed, device, a.seconds)
        print(json.dumps({"workload": a.workload, "seed": seed, **out}, default=float), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
