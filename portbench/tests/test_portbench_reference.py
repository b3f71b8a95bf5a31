"""The plain reference agrees with the port on a tiny VCoder-DS
configuration on the CPU, both in float32: prefill and decode logits, and
three stage-3 steps (losses and the trained leaves)."""

import torch

from portbench import drive, spec, traffic, weights
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train

FIXTURE = spec.HERE / "tests" / "fixture"
CFG = spec.config("tiny", FIXTURE / "configs")
D = spec.dims(CFG)


def test_prefill_and_decode_logits_match_the_port():
    from vcoder_tpu_torch.models import llama as llama_mod
    from vcoder_tpu_torch.models import vcoder as model_mod
    from vcoder_tpu_torch.multimodal import build_splice_plan

    mcfg = spec.model_config(CFG)
    w = weights.make(D, 7, "cpu")
    tr = traffic.Traffic(spec.mix("tiny-backlog", FIXTURE / "traffic"), 7, D)
    it = tr.item(0)
    px = traffic.pictures(7, "tiny-backlog", 0, D, "cpu").float()
    plan = build_splice_plan([it.ids], num_patches=D["n_patches"], has_seg=True, has_depth=True,
                             ds_mode=True, is_depth_zero=[False], pad_multiple=1)
    assert int(plan.seq_lens[0]) == it.expanded
    cache = llama_mod.KVCache.create(mcfg.text, 1, 64, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        logits, cache = model_mod.prefill(w, mcfg, model_mod.plan_to_arrays(plan, "cpu"),
                                          px[0:1], px[1:2], px[2:3], cache=cache,
                                          use_vcoder_emb=True)
        port = [logits[0]]
        for k in range(4):
            tok = port[-1].argmax()[None]
            pos = torch.tensor([it.expanded + k])
            logits, cache = model_mod.decode_step(w, mcfg, tok, pos, cache)
            port.append(logits[0])
    port = torch.stack(port)
    served = port.argmax(-1).tolist()
    ref = ref_model.served_logits(ref_model.Reference(w, D), [(it.ids, served, px)])[0]
    assert ref.shape == port.shape
    torch.testing.assert_close(port, ref, rtol=1e-4, atol=1e-4)


def test_three_stage3_steps_match_the_port():
    from vcoder_tpu_torch.train.step import init_opt_state, make_optimizer, make_train_step
    from vcoder_tpu_torch.train.trainer import epoch_batches

    cell = spec.cell("tiny.train", FIXTURE / "cells")
    mix = spec.mix("tiny-train", FIXTURE / "traffic")
    rec = cell["recipe"]
    mcfg = spec.model_config(CFG)
    w = weights.make(D, 9, "cpu")
    paths = weights.trainable_paths(w)
    start = {p: weights.leaf(w, p).clone() for p in paths}
    opt = make_optimizer(rec["learning_rate"], rec["schedule_steps"],
                         warmup_ratio=rec["warmup_ratio"], max_grad_norm=rec["max_grad_norm"])
    state = init_opt_state(w, opt, rec["stage"])
    step = make_train_step(mcfg, opt, stage=rec["stage"], remat=rec["remat"])
    rows = drive.Rows(traffic.Traffic(mix, 9, D), rec["schedule_steps"] * 4, 9, "cpu")
    feed = epoch_batches(mcfg, rows, drive.train_args(cell, mix), 0, device="cpu")
    losses, batches = [], []
    for k in range(3):
        before = len(rows.asked)
        w, state, m = step(w, state, next(feed))
        losses.append(float(m["loss"]))
        batches.append([(it.ids, it.labels, traffic.pictures(9, mix["name"], it.index, D, "cpu"))
                        for it in (rows.items[i] for i in rows.asked[before:])])
    ref = ref_train.run_steps(weights.make(D, 9, "cpu"), D, paths, batches, rec)
    torch.testing.assert_close(torch.tensor(losses), torch.tensor(ref["losses"]), rtol=1e-5,
                               atol=0)
    moved = 0
    for p in paths:
        change = weights.leaf(w, p).detach() - start[p]
        # Adam's update of a gradient near 0 turns on round-off: compare a
        # leaf's change as a whole.
        assert float((change - ref["change"][p]).norm()) <= 1e-4 * float(ref["change"][p].norm())
        moved += int(change.abs().max() > 0)
    assert moved == 5  # seg projector's four leaves and vcoder_lm_emb; depth never reached
