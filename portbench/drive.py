"""The two kinds of run: a training job and a serving engine under a
traffic mix. Each makes its inputs from the seed, warms up the cell's own
shapes, measures for ``seconds``, then hands the timed path's outputs to the
check (``check.py``) once the window has closed.

Training runs the program's own feed (``epoch_batches``: its sampler, its
collator and the length it pads each batch to) over the mix's rows, and
its ``Trainer``'s step; serving runs ``PagedServingEngine`` through
``add_request`` and ``step``.

A traced run profiles a slice right after the window, under the same load
(the same traffic goes on; an open loop's arrivals come at the window's
rate per step, since the profiler slows the host): the window itself is
never slowed by the profiler, so every host-clock number of a traced run
reads as an untraced one's would.

What the readers in ``metrics/`` read is the :class:`Run` a run returns:
host-clock records of every step and request in the window, the engine's
own ``StepTimer`` samples of the window, and the traced slice's steps and
trace.
"""

from __future__ import annotations

import copy
import dataclasses
import gc
import math
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from portbench import spec, traffic as traffic_mod, weights
from portbench.trace import span


@dataclasses.dataclass
class Step:
    t0: float
    t1: float
    tokens: int = 0  # output tokens emitted (serving), valid positions (training)
    labelled: int = 0
    contexts: List[int] = dataclasses.field(default_factory=list)  # decode attention spans
    prefills: List[int] = dataclasses.field(default_factory=list)  # admitted prompt positions
    rows: List[int] = dataclasses.field(default_factory=list)  # training rows' positions
    padded: int = 0  # training: the batch's positions, padding included


@dataclasses.dataclass
class Served:
    item: traffic_mod.Item
    added: float
    due: float
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class Run:
    kind: str
    cell: dict
    dims: dict
    seconds: float
    t0: float = 0.0
    t1: float = 0.0
    steps: List[Step] = dataclasses.field(default_factory=list)  # the window's
    traced: List[Step] = dataclasses.field(default_factory=list)  # the traced slice's
    served: Dict[int, Served] = dataclasses.field(default_factory=dict)
    timer: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    trace: object = None
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)
    check: Dict[str, dict] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Marks:
    """Set-up's parts: ``mark(name)`` waits for the device and files the
    seconds since the last mark (the first since ``t_start``) under
    ``name``."""

    def __init__(self, parts: dict, t_start: float, device):
        self.parts, self.last, self.device = parts, t_start, device

    def __call__(self, name: str) -> None:
        _sync(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now


def _traced(run: Run, work) -> None:
    """Profile ``work()`` (more of the run's own steps) into ``run.trace``."""
    from portbench.trace import Slice, Trace

    sl = Slice()
    sl.begin()
    work()
    sl.end()
    run.trace = Trace(sl)


# ---------------------------------------------------------------- training


class Rows:
    """The training mix as the stage's dataset, with the interface
    ``Trainer`` reads (``__len__``, ``__getitem__``, ``modality_lengths``):
    row ``i`` is the mix's item ``i``, its pictures the host arrays a loader
    hands the collator. Every index asked for is recorded in ``asked``, so
    the harness knows which rows each batch of the program's feed holds.
    With ``pictures`` off the rows carry zero pictures (a scan of the
    feed's shapes)."""

    def __init__(self, tr: traffic_mod.Traffic, n: int, seed: int, device, pictures: bool = True):
        self.tr, self.n, self.seed, self.device, self.pictures = tr, n, seed, device, pictures
        self.items = [tr.item(i) for i in range(n)]
        self.asked: List[int] = []

    def __len__(self) -> int:
        return self.n

    @property
    def modality_lengths(self) -> List[int]:
        return [it.n_text for it in self.items]

    def __getitem__(self, i: int) -> dict:
        self.asked.append(i)
        it = self.items[i]
        S = self.tr.dims["image"]
        if self.pictures:
            px = traffic_mod.pictures(self.seed, self.tr.mix["name"], i, self.tr.dims,
                                      self.device).float().cpu().numpy()
        else:
            px = np.zeros((3, S, S, 3), np.float32)
        return {"input_ids": it.ids, "labels": it.labels, "image": px[0], "seg": px[1],
                "depth": px[2]}


def train_args(cell: dict, mix: dict):
    """The recipe as the program's ``TrainArgs``: the feed inline (no loader
    threads, nothing prefetched), the sampler's seed fixed."""
    from vcoder_tpu_torch.train.trainer import TrainArgs

    rec = cell["recipe"]
    return TrainArgs(
        output_dir=os.path.join(tempfile.gettempdir(), "portbench-train"),
        stage=rec["stage"], learning_rate=rec["learning_rate"],
        per_device_train_batch_size=mix["rows_per_step"], warmup_ratio=rec["warmup_ratio"],
        max_grad_norm=rec["max_grad_norm"], remat=rec["remat"], dataloader_workers=0,
        prefetch_batches=0, seed=0,
    )


def first_rows(cell: dict, cfg: dict, mix: dict, seed: int) -> List[List[int]]:
    """The rows of the feed's first ``check_steps`` batches, as the
    program's sampler orders them (what a run's checked steps take)."""
    from vcoder_tpu_torch.train.trainer import epoch_batches

    d, rec = spec.dims(cfg), cell["recipe"]
    B = mix["rows_per_step"]
    rows = Rows(traffic_mod.Traffic(mix, seed, d), rec["schedule_steps"] * B, seed, "cpu",
                pictures=False)
    gen = epoch_batches(spec.model_config(cfg), rows, train_args(cell, mix), 0, device="cpu")
    for _ in range(rec["check_steps"]):
        next(gen)
    gen.close()
    return [rows.asked[k * B:(k + 1) * B] for k in range(rec["check_steps"])]


def feed(trainer, rows: Rows):
    """The program's own feed, epoch after epoch: ``epoch_batches`` (its
    sampler's order, its collator, the bucket it pads each batch to)."""
    from vcoder_tpu_torch.train.trainer import epoch_batches

    epoch = 0
    while True:
        yield from epoch_batches(trainer.cfg, rows, trainer.args, epoch, device=trainer.device)
        epoch += 1


def shapes_ahead(trainer, rows: Rows, skip: int, seen: set) -> List[tuple]:
    """(length, batch) for each sequence length that the feed pads a batch
    of the first epoch to, after ``skip`` batches, and ``seen`` lacks: the
    first such batch, from the feed run on the host over the same rows with
    zero pictures (a batch's length follows from its ids alone)."""
    from vcoder_tpu_torch.train.trainer import epoch_batches

    scan = copy.copy(rows)
    scan.pictures, scan.asked = False, []
    out = []
    for batch in epoch_batches(trainer.cfg, scan, trainer.args, 0, skip=skip, device="cpu"):
        length = int(batch["safe_ids"].shape[1])
        if length not in seen:
            seen.add(length)
            out.append((length, {k: v.to(trainer.device) for k, v in batch.items()}))
    return out


def run_train(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
              device, t_start: float, fault=None) -> Run:
    from vcoder_tpu_torch.train.trainer import Trainer

    from portbench import check
    from portbench.reference.train import B1

    d = spec.dims(cfg)
    mcfg = spec.model_config(cfg)
    run = Run(kind="train", cell=cell, dims=d, seconds=seconds)
    rec = cell["recipe"]
    B = mix["rows_per_step"]
    mark = Marks(run.notes.setdefault("setup_parts", {}), t_start, device)
    mark("imports")
    params = weights.make(d, seed, device)
    mark("weights")
    paths = weights.trainable_paths(params)
    rows = Rows(traffic_mod.Traffic(mix, seed, d), rec["schedule_steps"] * B, seed, device)
    trainer = Trainer(mcfg, params, rows, train_args(cell, mix), device=device)
    step_fn = fault(trainer.step_fn) if fault else trainer.step_fn
    start = {p: weights.leaf(trainer.params, p).detach().clone() for p in paths}
    batches = feed(trainer, rows)
    mark("trainer")

    def step(batch) -> float:
        with span("train_step"):
            trainer.params, trainer.opt_state, m = step_fn(trainer.params, trainer.opt_state, batch)
            return float(m["loss"])  # what Trainer logs every step

    def one():
        """The next batch of the feed through the trainer's step: (its
        record, its loss, its rows' indices)."""
        t0 = time.perf_counter()
        with span("feed"):
            before = len(rows.asked)
            batch = next(batches)
            idx = rows.asked[before:]
        loss = step(batch)
        t1 = time.perf_counter()
        items = [rows.items[i] for i in idx]
        lab = sum(sum(1 for x in it.labels[1:] if x != traffic_mod.IGNORE) for it in items)
        st = Step(t0, t1, tokens=sum(it.expanded for it in items), labelled=lab,
                  rows=[it.expanded for it in items], padded=batch["safe_ids"].numel())
        return st, loss, idx

    n_check = rec["check_steps"]
    losses, first_grad, check_rows, seen = [], None, [], set()
    for k in range(n_check):
        st, loss, idx = one()
        losses.append(loss)
        check_rows.append(idx)
        seen.add(st.padded // len(st.rows))
        if k == 0:
            first_grad = {p: trainer.opt_state[f"mu/{p}"].float() / (1 - B1) for p in paths}
    change = {p: weights.leaf(trainer.params, p).detach().float() - start[p].float() for p in paths}
    del start
    mark("checked_steps")
    # Warm-up: one step at each length the rest of the epoch pads to that
    # the checked steps did not.
    ahead = shapes_ahead(trainer, rows, n_check, seen)
    mark("scan")
    for length, batch in ahead:
        run.notes.setdefault("warmed_lengths", []).append(length)
        step(batch)
    del ahead
    mark("warm_steps")

    run.t0 = time.perf_counter()
    run.notes["setup_s"] = run.t0 - t_start
    while True:
        st, loss, _ = one()
        run.attempted += 1
        run.failed += not math.isfinite(loss)
        run.steps.append(st)
        if st.t1 - run.t0 >= seconds:
            break
    _sync(device)
    run.t1 = time.perf_counter()
    if device.type == "cuda":
        run.memory_peak = int(torch.cuda.max_memory_allocated(device))
    if trace:
        _traced(run, lambda: run.traced.extend(one()[0]
                                               for _ in range(int(mix.get("trace_steps", 2)))))
    # The program's state goes before the reference runs.
    trainer.release_state()
    del trainer, params, step_fn, batches
    _free(device)
    run.check, info = check.training(cfg, mix, cell, seed, device, check_rows, losses,
                                     first_grad, change)
    run.notes["check"] = {"losses": losses, **info}
    return run


# ---------------------------------------------------------------- serving


def _add(eng, tr, i: int, seed: int, mix: dict, device, now: float, due: float):
    """Item ``i`` handed to the engine: (its request id, its record)."""
    it = tr.item(i)
    px = traffic_mod.pictures(seed, mix["name"], i, tr.dims, device)
    with span("add_request"):
        rid = eng.add_request(it.ids, images=px[0:1], segs=px[1:2], depths=px[2:3],
                              max_new_tokens=it.out_len)
    return rid, Served(item=it, added=now, due=due)


def run_serve(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
              device, t_start: float, fault=None) -> Run:
    from vcoder_tpu_torch.serve.paged_engine import PagedServingEngine

    from portbench import check

    d = spec.dims(cfg)
    mcfg = spec.model_config(cfg)
    run = Run(kind="serve", cell=cell, dims=d, seconds=seconds)
    mark = Marks(run.notes.setdefault("setup_parts", {}), t_start, device)
    mark("imports")
    params = weights.make(d, seed, device)
    mark("weights")
    eng = PagedServingEngine(mcfg, params, eos_id=-1, seed=0, device=device, **cell["engine"])
    if fault:
        fault(eng)
    mark("engine")
    tr = traffic_mod.Traffic(mix, seed, d)

    # Warm-up: the cell's own shapes (its one prefill bucket, decode steps).
    warm = traffic_mod.Traffic({**mix, "name": mix["name"] + ".warm"}, seed, d)
    for i in range(int(mix.get("warm_requests", 2))):
        it = warm.item(i)
        px = traffic_mod.pictures(seed, mix["name"] + ".warm", i, d, device)
        eng.add_request(it.ids, images=px[0:1], segs=px[1:2], depths=px[2:3],
                        max_new_tokens=int(mix.get("warm_tokens", 4)))
    while eng.has_work():
        eng.step()
    eng.timer.samples.clear()
    mark("warm")

    nxt = 0
    late: List[float] = []
    pool = len(eng.free_pages)  # every page is free once the warm-up is done
    in_use: List[int] = []

    def step(into: List[Step]) -> Step:
        t0 = time.perf_counter()
        with span("step"):
            events = eng.step()
        t1 = time.perf_counter()
        st = Step(t0, t1)
        if into is run.steps:
            in_use.append(pool - len(eng.free_pages))
        for rid, tok, done in events:
            r = run.served.get(rid)
            if r is None:
                continue
            if r.tokens:
                st.contexts.append(r.item.expanded + len(r.tokens))
            else:
                st.prefills.append(r.item.expanded)
            r.tokens.append(int(tok))
            r.times.append(t1)
            r.done = r.done or bool(done)
            st.tokens += 1
        into.append(st)
        return st

    def add(due: float) -> None:
        nonlocal nxt
        now = time.perf_counter()
        rid, r = _add(eng, tr, nxt, seed, mix, device, now, due)
        run.served[rid] = r
        late.append(now - due)
        nxt += 1

    if mix["arrival"] == "backlog":
        depth = int(mix["backlog"])
        # Fill every row before the window; keep the queue deeper than
        # ``backlog`` through it.
        while len(run.served) < eng.max_batch + depth:
            add(time.perf_counter())
        while not eng.active.all():
            step([])
        mark("fill")
        run.t0 = time.perf_counter()

        def serve(until: float, into: List[Step]) -> None:
            while True:
                while len(eng.queue) < depth:
                    add(time.perf_counter())
                if step(into).t1 >= until:
                    return
    else:
        origin = time.perf_counter()
        run.t0 = origin + float(mix.get("lead_seconds", 0.0))

        def serve(until: float, into: List[Step]) -> None:
            while True:
                now = time.perf_counter()
                while origin + tr.due(nxt) <= now:
                    add(origin + tr.due(nxt))
                if now >= until:
                    return
                if eng.has_work():
                    st = step(into)
                    if st.t1 < run.t0:  # the lead-in
                        into.pop()
                else:
                    time.sleep(max(0.0, min(origin + tr.due(nxt), until) - now))

    serve(run.t0 + seconds, run.steps)
    _sync(device)
    run.t1 = time.perf_counter()
    run.notes["setup_s"] = run.t0 - t_start
    if device.type == "cuda":
        run.memory_peak = int(torch.cuda.max_memory_allocated(device))
    run.timer = {k: list(v) for k, v in eng.timer.samples.items()}
    run.notes.update(queued_at_end=len(eng.queue), active_at_end=int(eng.active.sum()))
    if in_use:  # the page pool as the window used it
        run.notes["pages"] = {"pool": pool, "max": max(in_use), "mean": sum(in_use) / len(in_use),
                              "bytes_each": int(eng.k_pages[:, 0].numel() * 2
                                                * eng.k_pages.element_size())}
    if mix["arrival"] == "backlog":
        run.attempted = len(run.served)
    else:
        run.attempted = sum(1 for r in run.served.values() if run.t0 <= r.due <= run.t0 + seconds)
        run.notes["arrival_late_ms"] = {"mean": 1e3 * sum(late) / max(len(late), 1),
                                        "max": 1e3 * max(late, default=0.0)}
    if trace:
        slice_s = float(mix.get("trace_seconds", 2.0))

        def traced_slice() -> None:
            end = time.perf_counter() + slice_s
            if mix["arrival"] == "backlog":
                serve(end, run.traced)
                return
            # The profiler slows the host, so arrivals by the wall clock
            # would find a queue at every step. The slice keeps the window's
            # load per step: its clock moves by the window's mean step time
            # at each step.
            per_step, first, clock = run.window_s / max(len(run.steps), 1), tr.due(nxt), 0.0
            while time.perf_counter() < end:
                while tr.due(nxt) - first <= clock:
                    add(time.perf_counter())
                if eng.has_work():
                    step(run.traced)
                clock += per_step

        _traced(run, traced_slice)
    run.failed = sum(1 for rid in run.served if rid in eng.failed)
    finished = {rid: r for rid, r in run.served.items() if r.done and rid not in eng.failed}
    eng.close()
    del eng, params
    _free(device)
    run.check, run.notes["check"] = check.serving(cfg, mix, cell, seed, device, finished)
    return run
