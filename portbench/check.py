"""Whether the timed path's outputs are correct: the comparison with the
plain reference, run once the window has closed and the program's state is
freed, on weights and inputs made again from the seed.

* Serving: a sample, drawn from the seed, of the requests the window
  finished, the longest among them, until it holds ``check.tokens`` served
  tokens and ``check.requests`` requests. The reference runs once over each
  prompt with its served tokens; ``served_gap`` is the widest gap by which a
  served token's reference logit lies below the reference's best at that
  position (tokens are greedy).
* Training: the first ``check_steps`` steps of the run, which went through
  the window's own step and feed (the program's sampler, collator and
  bucketing), on the rows that feed gave them; rows that repeat among them
  make the run not correct. ``loss_gap``: the largest relative gap of
  a step's loss. ``grad_gap``: over the leaves, the largest gap between the
  program's and the reference's norm of the first gradient as the update
  took it (the program's read from its first moment after one step,
  ``mu / (1 - b1)``), against the larger of that leaf's reference norm and
  the median leaf's. ``change_gap``: the same for each leaf's change over
  the steps. Leaves whose reference gradient is under a thousandth of the
  median leaf's are left out (the depth projector: the DS splice drops the
  depth block, so nothing reaches it).

Each number has its limit in the cell's ``check``; ``correct`` holds when
each is within it.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from portbench import spec, traffic as traffic_mod, weights
from portbench.reference import model as ref_model
from portbench.reference import train as ref_train


def _entry(value: float, limit: float) -> dict:
    return {"value": float(value), "limit": float(limit)}


def sample_requests(finished: dict, mix: dict, seed: int) -> List[int]:
    """Request ids to compare: the longest finished one, then others in an
    order drawn from the seed until the sample is large enough."""
    if not finished:
        return []
    want = mix["check"]
    ids = sorted(finished)
    longest = max(ids, key=lambda r: (len(finished[r].tokens), -r))
    order = [ids[i] for i in spec.seed_stream(seed, "check").permutation(len(ids))]
    pick, tokens = [longest], len(finished[longest].tokens)
    for r in order:
        if tokens >= want["tokens"] and len(pick) >= want["requests"]:
            break
        if r != longest:
            pick.append(r)
            tokens += len(finished[r].tokens)
    return pick


def reference_logits(w: dict, d: dict, rows, mode: str = "f32") -> List[torch.Tensor]:
    """The reference's logits at each served position of each row (ids,
    served tokens, pictures)."""
    ref_model.exact_math()
    return ref_model.served_logits(ref_model.Reference(w, d, mode=mode), rows)


def gaps(ref_logits: List[torch.Tensor], tokens) -> Dict[str, float]:
    """By how much ``tokens``' reference logit lies below the reference's
    best, over every row and position: the widest gap (``served_gap``) and
    the mean one (``served_gap_mean``)."""
    every = []
    for lg, tok in zip(ref_logits, tokens):
        tok = torch.as_tensor(tok, device=lg.device)
        every.append(lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0])
    every = torch.cat(every)
    return {"served_gap": float(every.max()), "served_gap_mean": float(every.mean())}


def compared(values: Dict[str, float], limits: Dict[str, float]):
    """(the numbers the cell compares, each with its limit; the others)."""
    return ({k: _entry(values[k], v) for k, v in limits.items()},
            {k: v for k, v in values.items() if k not in limits})


def serving(cfg: dict, mix: dict, cell: dict, seed: int, device, finished: dict):
    """(the numbers compared; what was compared and the numbers not
    compared)."""
    d = spec.dims(cfg)
    pick = sample_requests(finished, mix, seed)
    if not pick:
        return {k: _entry(float("inf"), v) for k, v in cell["check"].items()}, {}
    w = weights.make(d, seed, device)
    rows = served_rows(finished, pick, mix, seed, d, device)
    values = gaps(reference_logits(w, d, rows), [r[1] for r in rows])
    del w
    out, other = compared(values, cell["check"])
    return out, {"requests": len(rows), "tokens": sum(len(r[1]) for r in rows), **other}


def served_rows(finished: dict, pick, mix: dict, seed: int, d: dict, device):
    """(prompt ids, served tokens, pictures) of the picked requests, the
    pictures made again from the seed."""
    return [(finished[r].item.ids, finished[r].tokens,
             traffic_mod.pictures(seed, mix["name"], finished[r].item.index, d, device))
            for r in pick]


def train_rows(cfg: dict, mix: dict, seed: int, device, steps: List[List[int]]):
    """(ids, labels, pictures) of each row of each step, the rows given by
    their indices in the mix, the pictures made again from the seed."""
    d = spec.dims(cfg)
    tr = traffic_mod.Traffic(mix, seed, d)
    out = []
    for idx in steps:
        items = [tr.item(i) for i in idx]
        out.append([(it.ids, it.labels, traffic_mod.pictures(seed, mix["name"], it.index, d, device))
                    for it in items])
    return out


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor], counted,
              of_difference: bool = False) -> float:
    """The worst leaf's gap of norms (with ``of_difference``, its norm of
    the difference), against max(its reference norm, the median counted
    leaf's)."""
    rn = {p: float(ref[p].double().norm()) for p in counted}
    med = statistics.median(rn.values())

    def gap(p):
        if of_difference:
            return float((prog[p].double() - ref[p].double()).norm())
        return abs(float(prog[p].double().norm()) - rn[p])

    return max(gap(p) / max(rn[p], med) for p in counted)


def counted_leaves(grad: Dict[str, torch.Tensor]) -> List[str]:
    norms = {p: float(g.double().norm()) for p, g in grad.items()}
    med = statistics.median(norms.values())
    return [p for p, n in norms.items() if n >= 1e-3 * med]


def training(cfg: dict, mix: dict, cell: dict, seed: int, device, steps: List[List[int]],
             losses, first_grad, change):
    """(the numbers compared; the reference's losses, the leaves counted and
    the numbers not compared). ``steps``: the indices of each checked
    step's rows."""
    every = [i for idx in steps for i in idx]
    if len(set(every)) != len(every):
        return ({k: _entry(float("inf"), v) for k, v in cell["check"].items()},
                {"rows_repeat": steps})
    d = spec.dims(cfg)
    ref_model.exact_math()
    w = weights.make(d, seed, device)
    paths = weights.trainable_paths(w)
    batches = train_rows(cfg, mix, seed, device, steps)
    ref = ref_train.run_steps(w, d, paths, batches, cell["recipe"])
    del w
    values, counted = train_gaps({"losses": losses, "grad": first_grad, "change": change}, ref)
    out, other = compared(values, cell["check"])
    return out, {"ref_losses": ref["losses"], "counted": counted, "rows": steps, **other}


def train_gaps(prog: dict, ref: dict):
    """(the numbers, the leaves counted) of a run's losses, first gradients
    and changes against the reference's: ``loss_gap``, ``grad_gap`` and
    ``change_gap`` as above, and ``grad_diff``, ``change_diff``, the same
    with the norm of the difference in place of the gap of norms."""
    counted = counted_leaves(ref["grad"])
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_gap": leaf_gaps(prog["grad"], ref["grad"], counted),
        "change_gap": leaf_gaps(prog["change"], ref["change"], counted),
        "grad_diff": leaf_gaps(prog["grad"], ref["grad"], counted, of_difference=True),
        "change_diff": leaf_gaps(prog["change"], ref["change"], counted, of_difference=True),
    }, counted


def correct(check: Dict[str, dict]) -> bool:
    return all(e["value"] <= e["limit"] for e in check.values())
