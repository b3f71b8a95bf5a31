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
donates the old ones); the returned params are the same dictionary.

``offload_shardings`` is the zero3_offload analog (``step.py:132-296``): the
shaped optimizer-state leaves live in host memory (``parallel/sharding.py``)
and are STREAMED through the device after the gradients and their global
norm: each trainable leaf is walked along axis 0 in chunks of at most
``OFFLOAD_CHUNK_BYTES`` (one layer of a stacked 7B MLP weight), each chunk's
``mu``/``nu`` (``acc`` under accumulation) is copied into one of two device
staging buffers on a copy stream while the chunk before it is updated, gets
the same elementwise update as the resident step, and is copied back on a
second copy stream, each copy ordered by CUDA events. The update is
elementwise, so the chunks change no number: the offloaded step's parameters
and state are the resident step's, bit for bit. (JAX uploads the whole state
inside its jit and returns it host-pinned.) The device never holds more of
the state than the staging buffers.

Over a distributed mesh (``parallel/spmd.py``) the parameters, gradients and
moments are DTensors placed by ``parallel/sharding.py``'s rules and the
batch holds this rank's rows (``shard_batch``). The loss and the metrics
come out replicated: the loss summed over the row shards, the norms from
one all-reduce of every leaf's local sum of squares (each shard counted
once). AdamW's elementwise body runs on each rank's local shards, so it is
the DTensor update bit for bit; the offloaded step streams each rank's
local moments through its ``StateStager``.
"""

from __future__ import annotations

import contextlib
import math
import re
from typing import Callable, Dict, List, Optional

import torch

from vcoder_tpu_torch.config import VCoderConfig
from vcoder_tpu_torch.models import vcoder as model_mod
from vcoder_tpu_torch.parallel import spmd
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


def _local(t):
    """A DTensor's local shard (the tensor itself under ``no_grad``, so
    in-place updates land in the DTensor); a plain tensor as is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def sq_sum(t: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of ``t``'s elements, taken over axis-0 chunks
    of at most ``OFFLOAD_CHUNK_BYTES`` (``chunk_rows``) when ``t`` is larger:
    no f32 copy of a whole stacked leaf is made (a 13B ``gate_proj``
    gradient would take 10.5 GiB). A tensor of one chunk is summed whole."""
    rows = chunk_rows(t)
    if len(rows) == 1:
        return t.float().square().sum()
    return sum(t[r].float().square().sum() for r in rows)


def sharded_sq_sums(tensors) -> torch.Tensor:
    """[n] f32: each tensor's global sum of squares, from one all-reduce of
    the local sums over the whole group. A rank adds a shard only when it is
    the first of its replicas (coordinate 0 on every mesh dimension the
    tensor is replicated over), so each element counts once."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    m = spmd.mesh()
    sums = []
    for t in tensors:
        owner = all(m.device_mesh.get_local_rank(i) == 0 for i, p in enumerate(
            t.placements if isinstance(t, DTensor) else [None] * 3) if p is None or not p.is_shard())
        local = sq_sum(_local(t))
        sums.append(local if owner else torch.zeros_like(local))
    out = torch.stack(sums)
    dist.all_reduce(out)
    return out


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32 (optax's
    ``global_norm``); over DTensors, of the whole (sharded) tensors."""
    tensors = list(tensors)
    if spmd.mesh() is not None:
        return torch.sqrt(sharded_sq_sums(tensors).sum())
    return torch.sqrt(sum(sq_sum(t) for t in tensors))


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

    # The elementwise pieces, shared by the resident update (whole tensors)
    # and the offloaded one (chunks), so the two compute the same numbers.

    @staticmethod
    def _accumulate(acc: torch.Tensor, g: torch.Tensor, n: int) -> None:
        acc.add_((g - acc) / (n + 1))

    def _clip(self, g: torch.Tensor, g_norm: Optional[torch.Tensor]) -> torch.Tensor:
        return g if g_norm is None else (g / g_norm.to(g.dtype)) * self.max_grad_norm

    def _adam(self, p, g, mu, nu, bc1, bc2, step_size) -> None:
        mu.copy_((1 - self.b1) * g + self.b1 * mu)
        nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
        u = (mu / bc1.to(mu.dtype)) / (torch.sqrt(nu / bc2.to(nu.dtype)) + self.eps)
        if self.weight_decay:
            u = u + self.weight_decay * p
        p.add_(step_size.to(device=u.device, dtype=u.dtype) * u)

    def _clip_norm(self, grads) -> Optional[torch.Tensor]:
        """The global norm when clipping engages, else None."""
        if self.max_grad_norm is None:
            return None
        g_norm = global_norm(grads)
        return None if bool(g_norm < self.max_grad_norm) else g_norm

    def _scalars(self, state):
        count = int(state["count"])
        c = torch.tensor(count + 1, dtype=torch.float32)
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32) ** c
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32) ** c
        return bc1, bc2, -self.schedule(count)

    @torch.no_grad()
    def update(self, leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
               state: Dict[str, torch.Tensor]) -> None:
        """One optimizer call on one micro-batch's gradients: parameters and
        state change in place."""
        if self.accum_steps > 1:
            n = int(state["mini_step"])
            for path, g in grads.items():
                self._accumulate(_local(state[f"acc/{path}"]), _local(g), n)
            if n + 1 < self.accum_steps:
                state["mini_step"].fill_(n + 1)
                return
            grads = {path: state[f"acc/{path}"].clone() for path in grads}
            for path in grads:
                _local(state[f"acc/{path}"]).zero_()
            state["mini_step"].zero_()
            state["gradient_step"].add_(1)
        g_norm = self._clip_norm(grads.values())
        grads = {p: self._clip(_local(g), g_norm) for p, g in grads.items()}
        bc1, bc2, step_size = self._scalars(state)
        for path, p in leaves.items():
            self._adam(_local(p), grads[path], _local(state[f"mu/{path}"]),
                       _local(state[f"nu/{path}"]), bc1, bc2, step_size)
        state["count"].add_(1)

    @torch.no_grad()
    def update_offloaded(self, leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                         state: Dict[str, torch.Tensor], stager: "StateStager") -> None:
        """:meth:`update` with the shaped state leaves in host memory,
        streamed through ``stager`` chunk by chunk. ``grads`` are consumed:
        under accumulation they are overwritten with the averaged gradient.
        Over a mesh the host state holds this rank's shards."""
        sharded = grads
        grads = {p: _local(g) for p, g in grads.items()}
        leaves = {p: _local(t) for p, t in leaves.items()}
        if self.accum_steps > 1:
            n = int(state["mini_step"])
            last = n + 1 >= self.accum_steps

            def acc_chunk(path, rows, staged):
                a, g = staged["acc"], grads[path][rows]
                self._accumulate(a, g, n)
                if last:  # the averaged gradient moves to grads; acc restarts at 0
                    g.copy_(a)
                    a.zero_()

            stager.stream(state, leaves, ("acc",), acc_chunk)
            if not last:
                state["mini_step"].fill_(n + 1)
                return
            state["mini_step"].zero_()
            state["gradient_step"].add_(1)
        g_norm = self._clip_norm(sharded.values())
        bc1, bc2, step_size = self._scalars(state)

        def adam_chunk(path, rows, staged):
            self._adam(leaves[path][rows], self._clip(grads[path][rows], g_norm),
                       staged["mu"], staged["nu"], bc1, bc2, step_size)

        stager.stream(state, leaves, ("mu", "nu"), adam_chunk)
        state["count"].add_(1)


# The largest chunk of one state leaf streamed at a time (whole rows of
# axis 0: one layer of a stacked [32, 4096, 11008] bf16 weight is 90 MB).
OFFLOAD_CHUNK_BYTES = 64 << 20


def chunk_rows(t: torch.Tensor, max_bytes: Optional[int] = None) -> List[slice]:
    """Slices of axis 0 of ``t``, each of at most ``max_bytes`` (default
    ``OFFLOAD_CHUNK_BYTES``; at least one row); a 0-d tensor is one chunk
    (``...``)."""
    if t.ndim == 0:
        return [Ellipsis]
    row = max(math.prod(t.shape[1:]) * t.element_size(), 1)
    step = max((max_bytes or OFFLOAD_CHUNK_BYTES) // row, 1)
    return [slice(a, min(a + step, t.shape[0])) for a in range(0, t.shape[0], step)]


class StateStager:
    """Streams host-resident state leaves through the device for the
    offloaded update (:meth:`AdamW.update_offloaded`).

    Chunks go through two staging slots per streamed kind. On CUDA, chunk
    i + 1 is copied in on the ``h2d`` stream while chunk i is updated on the
    compute stream, and chunk i goes back on the ``d2h`` stream; a slot is
    refilled only after its previous chunk is back on the host (events). The
    pass ends with the host waiting for the last copy, so the state is whole
    when the step returns. State leaves already on the device are updated in
    place. :meth:`pop_stats` gives the copy and update times (ms, from the
    streams' events; CUDA only).

    ``host_keys``: the state keys in host memory; every other key is on the
    device and updated in place."""

    def __init__(self, device, host_keys):
        self.device = torch.device(device)
        self.host_keys = frozenset(host_keys)
        self.cuda = self.device.type == "cuda"
        self.bufs: Dict[tuple, torch.Tensor] = {}
        self.passes: list = []
        if self.cuda:
            self.h2d = torch.cuda.Stream(self.device)
            self.d2h = torch.cuda.Stream(self.device)

    def _slots(self, kinds, nbytes: int) -> None:
        """Two staging buffers per kind, of at least ``nbytes``."""
        for kind in kinds:
            for slot in (0, 1):
                b = self.bufs.get((kind, slot))
                if b is None or b.numel() < nbytes:
                    if b is not None and self.cuda:
                        torch.cuda.synchronize(self.device)  # no copy still uses it
                    self.bufs[(kind, slot)] = torch.empty(nbytes, dtype=torch.uint8,
                                                          device=self.device)

    def _staged(self, kind, slot, src: torch.Tensor) -> torch.Tensor:
        n = src.numel() * src.element_size()
        return self.bufs[(kind, slot)][:n].view(src.dtype).view(src.shape)

    def stream(self, state, leaves, kinds, fn) -> None:
        """``fn(path, rows, staged)`` for every chunk of every leaf, where
        ``staged[kind]`` is the device copy of ``state[f"{kind}/{path}"][rows]``,
        written back after ``fn`` changed it in place."""
        work = []  # (path, rows, {kind: (state chunk, whether it is on the host)})
        for path, p in leaves.items():
            for rows in chunk_rows(p):
                work.append((path, rows, {k: (state[f"{k}/{path}"][rows],
                                              f"{k}/{path}" in self.host_keys) for k in kinds}))
        sizes = [h.numel() * h.element_size() for _, _, hs in work for h, off in hs.values()
                 if off]
        self._slots(kinds, max(sizes, default=0))
        if not work:
            return
        if not self.cuda:
            for i, (path, rows, host) in enumerate(work):
                staged = {k: self._staged(k, i % 2, h).copy_(h) if off else h
                          for k, (h, off) in host.items()}
                fn(path, rows, staged)
                for k, (h, off) in host.items():
                    if off:
                        h.copy_(staged[k])
            return
        self._stream_cuda(work, fn)

    def _stream_cuda(self, work, fn) -> None:
        compute = torch.cuda.current_stream(self.device)

        def ev():
            return torch.cuda.Event(enable_timing=True)

        n = len(work)
        loaded, stored = [None] * n, [None] * n
        marks = dict(h2d=[], d2h=[], update=[])
        start = ev()
        start.record(compute)

        def load(i):
            slot = i % 2
            with torch.cuda.stream(self.h2d):
                # The staging buffers come from the compute stream's pool.
                self.h2d.wait_event(start)
                if i >= 2:
                    self.h2d.wait_event(stored[i - 2])  # the slot is back on the host
                a, b = ev(), ev()
                a.record(self.h2d)
                staged = {}
                for k, (h, off) in work[i][2].items():
                    staged[k] = self._staged(k, slot, h).copy_(h, non_blocking=True) if off else h
                b.record(self.h2d)
                marks["h2d"].append((a, b))
                loaded[i] = (b, staged)

        load(0)
        for i, (path, rows, host) in enumerate(work):
            if i + 1 < n:
                load(i + 1)
            done_loading, staged = loaded[i]
            compute.wait_event(done_loading)
            a, b = ev(), ev()
            a.record(compute)
            fn(path, rows, staged)
            b.record(compute)
            marks["update"].append((a, b))
            with torch.cuda.stream(self.d2h):
                self.d2h.wait_event(b)
                c, d = ev(), ev()
                c.record(self.d2h)
                for k, (h, off) in host.items():
                    if off:
                        h.copy_(staged[k], non_blocking=True)
                d.record(self.d2h)
                marks["d2h"].append((c, d))
                stored[i] = d
            loaded[i] = None
        compute.wait_stream(self.d2h)
        stored[-1].synchronize()  # the host state is whole when the step returns
        marks["pass"] = (start, stored[-1])
        self.passes.append(marks)

    def pop_stats(self) -> dict:
        """Times of the passes since the last call (ms): ``h2d``, ``d2h`` and
        ``update`` summed over their chunks, ``wall`` from the first event to
        the last copy back."""
        out = dict(h2d=0.0, d2h=0.0, update=0.0, wall=0.0, chunks=0)
        for marks in self.passes:
            for key in ("h2d", "d2h", "update"):
                out[key] += sum(a.elapsed_time(b) for a, b in marks[key])
            out["wall"] += marks["pass"][0].elapsed_time(marks["pass"][1])
            out["chunks"] += len(marks["update"])
        self.passes = []
        return out


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


def _as_placed(g, t):
    """A DTensor gradient placed like its parameter (a partial sum reduced)."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and g.placements != t.placements:
        return g.redistribute(t.device_mesh, t.placements)
    return g


def _local_batch(batch: dict) -> dict:
    """This rank's rows of a batch: a DTensor's local part (``shard_batch``),
    or the rank's slice of a global batch every rank holds whole."""
    from torch.distributed.tensor import DTensor

    out = {}
    for k, x in batch.items():
        if isinstance(x, DTensor):
            out[k] = x.to_local()
        elif isinstance(x, torch.Tensor) and x.ndim:
            out[k] = x[spmd.row_slice(x.shape[0])]
        else:
            out[k] = x
    return out


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
    tensors on the device.

    ``offload_shardings=(dev_sh, host_sh)`` (``parallel.sharding``'s
    placements of the state's keys) streams the host-resident state through
    the device in the update (the module docstring); the step's
    ``StateStager`` is its ``stager`` attribute."""
    stager = None
    if offload_shardings is not None:
        dev_sh, host_sh = offload_shardings
        devices = {s.device for s in dev_sh.values()}
        if len(devices) != 1:
            raise NotImplementedError(f"opt state over {len(devices)} devices: the port's "
                                      "offload runs on one device")
        stager = StateStager(devices.pop(), [k for k, s in host_sh.items() if s.on_host])
    use_seg, use_depth = cfg.use_seg, cfg.use_depth

    def step(params, opt_state, batch):
        mesh = spmd.mesh()
        if mesh is not None:
            batch = _local_batch(batch)
        leaves = trainable_leaves(params, stage)
        for t in leaves.values():
            t.requires_grad_(True)
        with spmd.local_rows() if mesh is not None else contextlib.nullcontext():
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
            path: torch.zeros_like(t) if g is None else _as_placed(g, t)
            for (path, t), g in zip(leaves.items(), grads)
        }
        if mesh is None:
            leaf_norms = {path: global_norm([g]) for path, g in grads.items()}
            gnorm = global_norm(grads.values())
        else:
            sq = sharded_sq_sums(list(grads.values()))
            leaf_norms = dict(zip(grads, torch.sqrt(sq).unbind()))
            gnorm = torch.sqrt(sq.sum())
            loss = spmd.sum_rows(loss.detach())
        if stager is None:
            optimizer.update(leaves, grads, opt_state)
        else:
            optimizer.update_offloaded(leaves, grads, opt_state, stager)
        return params, opt_state, {
            "loss": loss.detach(), "grad_norm": gnorm, "leaf_grad_norms": leaf_norms,
        }

    step.stager = stager
    return step
