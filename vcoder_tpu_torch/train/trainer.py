"""Training loop: bucketing, checkpoint/resume, logging (port of
``vcoder_tpu/train/trainer.py:43-398``).

* Batches collate into bucketed static sequence lengths (``BUCKETS``), as
  in the JAX package, so the kernels see a handful of shapes.
* The step is ``train/step.py``'s, on one device (CUDA unless the caller
  passes ``device="cpu"``) or over a mesh. ``mesh`` may be a one-device
  ``parallel.Mesh`` (its device must be ``device``) or a distributed one
  (``parallel/launch.py``; ``trainer.py:125-148,219-222``): then this
  process is one rank, its device the mesh's, the parameters are sharded
  by ``parallel/sharding.py``'s rules (in the caller's dictionaries), the
  global batch is ``per_device_train_batch_size x data x fsdp`` and every
  rank draws it whole from the seeded sampler and keeps its rows
  (``shard_batch``). Rank 0 writes the checkpoints, ``adapters.safetensors``
  and ``metrics.jsonl``, gathering one leaf at a time, with barriers
  around each write; resume re-shards what it reads. A plain mesh of
  several devices (no process group) raises ``NotImplementedError``.
* ``offload_opt_state`` (the zero3_offload analog) needs a mesh, as in the
  JAX package: the shaped optimizer-state leaves are made in host memory
  (pinned on CUDA; ``parallel/sharding.py``) and streamed through the device
  by the step. Checkpoints read and write them in place.
* Checkpoints are ``checkpoint-<step>/state.safetensors`` (params under
  ``params/<path>``, optimizer state under ``opt/<key>``, and ``step``),
  written and read by the port's own safetensors code, rotated to
  ``save_total_limit``; resume takes the newest and fast-forwards the data
  stream past the consumed batches. The JAX package writes Orbax
  directories instead: neither reads the other's.
* ``save_adapters`` writes the trainable leaves to ``adapters.safetensors``
  under the JAX package's leaf paths (the analog of the reference's
  ``mm_projector.bin`` exports).
* Metrics stream to ``metrics.jsonl``.
* The prefetch producer thread is joined when the consumer stops, so no
  thread outlives ``train`` (the JAX package's producer is left running).

The dataset is any object with ``__len__``, ``__getitem__`` (a dict with
``input_ids``, ``labels`` and optional ``image``/``seg``/``depth`` pixel
arrays [H, W, 3]) and ``modality_lengths``: the interface of the JAX
package's ``VCoderDataset``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import glob
import json
import os
import queue
import shutil
import threading
import time
from typing import Iterator, List, Optional

import torch

from vcoder_tpu_torch.checkpoint import read_safetensors, write_safetensors
from vcoder_tpu_torch.config import VCoderConfig
from vcoder_tpu_torch.device import resolve_device
from vcoder_tpu_torch.parallel.mesh import barrier, multi_device_error, rank_zero
from vcoder_tpu_torch.parallel.sharding import (
    device_shardings_like,
    host_shardings,
    shard_batch,
    shard_params,
)
from vcoder_tpu_torch.train.collator import collate_batch
from vcoder_tpu_torch.train.sampler import LengthGroupedSampler
from vcoder_tpu_torch.train.step import (
    init_opt_state,
    make_optimizer,
    make_train_step,
    trainable_leaves,
)
from vcoder_tpu_torch.tree import named_leaves

BUCKETS = (256, 512, 768, 1024, 1536, 2048, 2560, 3072, 4096)


def bucket_length(n: int, buckets=BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def epoch_batches(
    cfg: VCoderConfig, dataset, args: "TrainArgs", epoch: int, *, skip: int = 0, device="cuda",
    world: int = 1,
) -> Iterator[dict]:
    """The collated batches of one epoch as ``Trainer`` consumes them: the
    sampler's order for ``epoch``, ``per_device_train_batch_size x world``
    samples each (``world``: the row shards of a mesh), padded to the
    bucket of the longest expanded sample; ``skip`` drops the first N
    batches by slicing the order (no loading or collation for them)."""
    B = args.per_device_train_batch_size * world
    sampler = LengthGroupedSampler(
        args.per_device_train_batch_size,
        world,
        dataset.modality_lengths
        if args.group_by_modality_length
        else [abs(l) for l in dataset.modality_lengths],
        seed=args.seed,
        group_by_modality=args.group_by_modality_length,
    )
    sampler.set_epoch(epoch)
    order = list(iter(sampler))
    pool = None
    if args.dataloader_workers > 0:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(args.dataloader_workers)
    n_mod = 1 + int(cfg.use_seg) + int(cfg.use_depth)
    try:
        for i in range(skip * B, len(order) - B + 1, B):
            idxs = order[i:i + B]
            if pool is not None:
                samples = list(pool.map(dataset.__getitem__, idxs))
            else:
                samples = [dataset[j] for j in idxs]
            expanded = max(len(s["input_ids"]) for s in samples) + n_mod * cfg.vision.num_patches
            yield collate_batch(
                samples,
                num_patches=cfg.vision.num_patches,
                ds_mode=cfg.model_type == "vcoder_ds_llava",
                it_mode=cfg.model_type == "vcoder_it_llava",
                use_seg=cfg.use_seg,
                use_depth=cfg.use_depth,
                image_size=cfg.vision.image_size,
                pad_to=bucket_length(min(expanded, BUCKETS[-1])),
                device=device,
            )
    finally:
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)


@dataclasses.dataclass
class TrainArgs:
    """Hyperparameters mirroring scripts/v1_5/*.sh (reference defaults:
    lr 1e-3 adapters / 2e-5 full, cosine, warmup 0.03, model_max_length
    2048, bf16); the fields of the JAX package's ``TrainArgs``."""

    output_dir: str = "./output"
    stage: str = "vcoder_ds"
    learning_rate: float = 1e-3
    num_train_epochs: int = 1
    per_device_train_batch_size: int = 4
    gradient_accumulation_steps: int = 1
    warmup_ratio: float = 0.03
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    logging_steps: int = 1
    save_steps: int = 1100
    save_total_limit: int = 1
    model_max_length: int = 2048
    group_by_modality_length: bool = True
    seed: int = 42
    remat: object = "dots"  # True | "dots" | False
    attn_impl: str = "auto"
    # zero3_offload analog (reference: scripts/zero3_offload.json): the
    # optimizer state in host memory, streamed through the device per step.
    # Requires a mesh (wrap one card in single_device_mesh()).
    offload_opt_state: bool = False
    # Host input pipeline: threads loading samples (0 = inline) and how
    # many collated batches to stage ahead of the step.
    dataloader_workers: int = 8
    prefetch_batches: int = 2


class Trainer:
    def __init__(
        self,
        cfg: VCoderConfig,
        params: dict,
        dataset,
        args: TrainArgs,
        *,
        mesh=None,
        device="cuda",
    ):
        if mesh is not None and mesh.size > 1 and not mesh.distributed:
            raise multi_device_error(mesh.size)
        self.device = resolve_device(device)
        if mesh is not None and (mesh.device.type, mesh.device.index or 0) != (
                self.device.type, self.device.index or 0):
            raise ValueError(f"the mesh's device {mesh.device} is not the trainer's {self.device}")
        self.mesh = mesh
        off = [p for p, t in named_leaves(params) if t.device.type != self.device.type]
        if off:
            raise ValueError(f"params lie off {self.device} (e.g. {off[0]})")
        self.sharded = mesh is not None and mesh.distributed
        if self.sharded:
            self.device = mesh.device
            shard_params(params, mesh)
        self.cfg = cfg
        self.args = args
        self.dataset = dataset
        world = 1 if mesh is None else mesh.shape["data"] * mesh.shape["fsdp"]
        self.global_batch = args.per_device_train_batch_size * world
        self.accum = max(args.gradient_accumulation_steps, 1)
        # self.step / total_steps count MICRO-batches; the schedule runs in
        # optimizer updates.
        self.micro_per_epoch = max(len(dataset) // self.global_batch, 1)
        self.total_steps = self.micro_per_epoch * args.num_train_epochs
        total_updates = max(self.total_steps // self.accum, 1)
        self.optimizer = make_optimizer(
            args.learning_rate,
            total_updates,
            warmup_ratio=args.warmup_ratio,
            weight_decay=args.weight_decay,
            max_grad_norm=args.max_grad_norm,
            accum_steps=self.accum,
        )
        self.params = params
        offload_shardings = None
        if args.offload_opt_state:
            if mesh is None:
                raise ValueError(
                    "offload_opt_state requires a mesh (host placements are mesh-relative; "
                    "wrap one card in parallel.single_device_mesh())")
            # The state's shapes, then its zeros made where they live: the
            # moments never pass through the device whole.
            # Over a distributed mesh: this rank's shards of them.
            meta = {p: _local(t).to("meta")
                    for p, t in trainable_leaves(params, args.stage).items()}
            shapes = self.optimizer.init(meta)
            host_sh = host_shardings(shapes, mesh)
            self.opt_state = {k: host_sh[k].zeros(t) for k, t in shapes.items()}
            offload_shardings = (device_shardings_like(host_sh), host_sh)
        else:
            self.opt_state = init_opt_state(params, self.optimizer, args.stage)
        # Each state key's parameter placements (a distributed mesh's host
        # shards are plain tensors; checkpoints wrap them back).
        self._placements = {}
        if self.sharded:
            for p, t in trainable_leaves(params, args.stage).items():
                for kind in ("mu", "nu", "acc"):
                    self._placements[f"{kind}/{p}"] = t.placements
        self.step_fn = make_train_step(
            cfg, self.optimizer, stage=args.stage, attn_impl=args.attn_impl, remat=args.remat,
            offload_shardings=offload_shardings,
        )
        self.step = 0
        self.prefetch_thread: Optional[threading.Thread] = None
        os.makedirs(args.output_dir, exist_ok=True)
        self._metrics_path = os.path.join(args.output_dir, "metrics.jsonl")

    # ---- data ----

    def _epoch_batches(self, epoch: int, skip: int = 0) -> Iterator[dict]:
        gen = epoch_batches(self.cfg, self.dataset, self.args, epoch, skip=skip,
                            device=self.device, world=self.global_batch //
                            self.args.per_device_train_batch_size)
        if not self.sharded:
            return gen
        return (shard_batch(b, self.mesh) for b in gen)

    def _prefetched(self, gen: Iterator[dict]) -> Iterator[dict]:
        """Stage up to ``args.prefetch_batches`` collated batches ahead of
        the consumer in a background thread. When the consumer stops (end
        of data, a step budget, an error) the producer is told to stop, is
        joined, and the batch generator is closed."""
        n = self.args.prefetch_batches
        if n <= 0:
            yield from gen
            return
        q: "queue.Queue" = queue.Queue(maxsize=n)
        done = object()
        stop = threading.Event()
        err: list = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def work():
            try:
                for b in gen:
                    if not put(b):
                        return
            except BaseException as e:  # surfaced in the consumer
                err.append(e)
            finally:
                put(done)

        t = threading.Thread(target=work, daemon=True, name="prefetch")
        self.prefetch_thread = t
        t.start()
        try:
            while True:
                b = q.get()
                if b is done:
                    break
                yield b
        finally:
            stop.set()
            t.join()
            gen.close()
        if err:
            raise err[0]

    # ---- checkpointing ----

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.args.output_dir, f"checkpoint-{step}")

    def _checkpoints(self) -> List[str]:
        return sorted(
            glob.glob(os.path.join(self.args.output_dir, "checkpoint-*")),
            key=lambda p: int(p.rsplit("-", 1)[-1]),
        )

    def _opt_global(self) -> dict:
        """The optimizer state as written: over a distributed mesh each
        host-resident shard becomes a DTensor placed like its parameter (a
        device copy; the 0-d counters, equal on every rank, as they are)."""
        if not (self.sharded and self.args.offload_opt_state):
            return dict(self.opt_state)
        from torch.distributed.tensor import DTensor

        out = {}
        for k, t in self.opt_state.items():
            pl = self._placements.get(k)
            out[k] = t if pl is None else DTensor.from_local(
                t.to(self.device), self.mesh.device_mesh, pl, run_check=False)
        return out

    def save_checkpoint(self) -> str:
        """Params, optimizer state and step into
        ``checkpoint-<step>/state.safetensors``; older checkpoints beyond
        ``save_total_limit`` are removed."""
        path = os.path.abspath(self._ckpt_dir(self.step))
        state_file = os.path.join(path, "state.safetensors")
        exists = os.path.exists(state_file)
        barrier()  # every rank has looked before rank 0 writes
        if exists:
            return path  # the end of an epoch can land on a save step again
        if rank_zero():
            os.makedirs(path, exist_ok=True)
        state = {f"params/{p}": t for p, t in named_leaves(self.params)}
        state.update({f"opt/{k}": t for k, t in self._opt_global().items()})
        state["step"] = torch.tensor(self.step, dtype=torch.int64)
        write_safetensors(state_file + ".tmp", state)
        if rank_zero():
            os.replace(state_file + ".tmp", state_file)
            ckpts = self._checkpoints()
            while len(ckpts) > self.args.save_total_limit:
                victim = ckpts.pop(0)
                if victim != path:
                    shutil.rmtree(victim, ignore_errors=True)
        barrier()
        return path

    def maybe_resume(self) -> bool:
        """Resume from the newest checkpoint-* directory if there is one
        (reference: train/train.py:1079-1082): params and optimizer state
        are copied into this trainer's tensors in place."""
        ckpts = self._checkpoints()
        if not ckpts:
            return False
        state = read_safetensors(os.path.join(ckpts[-1], "state.safetensors"))
        with torch.no_grad():
            for p, t in named_leaves(self.params):
                _copy_in(t, state[f"params/{p}"], self.mesh)
            for k, t in self.opt_state.items():
                _copy_in(t, state[f"opt/{k}"], self.mesh, self._placements.get(k))
        self.step = int(state["step"])
        return True

    def save_adapters(self) -> str:
        """The trainable leaves alone, keyed by their paths, into
        ``adapters.safetensors`` (``trainer.py:342-357``)."""
        out = os.path.join(self.args.output_dir, "adapters.safetensors")
        write_safetensors(out, trainable_leaves(self.params, self.args.stage))
        barrier()
        return out

    def release_state(self) -> None:
        """Drop what only further steps use -- the optimizer state and the
        step function (with an offloaded step's staging buffers) -- and hand
        the freed blocks back to the device; ``params`` stay. A driver calls
        this before it builds another copy of the weights (the merged LoRA
        tree of ``final/``)."""
        self.opt_state = {}
        self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- loop ----

    def train(self, max_steps: Optional[int] = None) -> List[dict]:
        if self.sharded:
            from vcoder_tpu_torch.parallel.mesh import use_mesh

            with use_mesh(self.mesh):  # the model code reads the thread's mesh
                return self._train(max_steps)
        return self._train(max_steps)

    def _train(self, max_steps: Optional[int] = None) -> List[dict]:
        history = []
        t_start = time.time()
        budget = max_steps or self.total_steps
        # On resume, fast-forward past already-consumed batches so the run
        # sees the same data stream as an uninterrupted one.
        start_epoch = self.step // self.micro_per_epoch
        skip_in_epoch = self.step % self.micro_per_epoch
        for epoch in range(start_epoch, self.args.num_train_epochs):
            to_skip = skip_in_epoch if epoch == start_epoch else 0
            with contextlib.closing(
                self._prefetched(self._epoch_batches(epoch, skip=to_skip))
            ) as batches:
                for batch in batches:
                    if self.step >= budget:
                        break
                    t0 = time.time()
                    self.params, self.opt_state, metrics = self.step_fn(
                        self.params, self.opt_state, batch
                    )
                    self.step += 1
                    if self.step % self.args.logging_steps == 0:
                        rec = {
                            "step": self.step,
                            "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"]),
                            "step_time_s": round(time.time() - t0, 4),
                            "elapsed_s": round(time.time() - t_start, 1),
                        }
                        history.append(rec)
                        if rank_zero():
                            with open(self._metrics_path, "a") as f:
                                f.write(json.dumps(rec) + "\n")
                    if self.step % self.args.save_steps == 0:
                        self.save_checkpoint()
            if self.step >= budget:
                break
        return history


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _copy_in(t: torch.Tensor, full: torch.Tensor, mesh, placements=None) -> None:
    """Copy a whole tensor read from a checkpoint into ``t``: a DTensor (or,
    with ``placements``, a host local shard) takes this rank's slice."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(t, DTensor):
        placements, t = t.placements, t.to_local()
    if placements is not None:
        full = distribute_tensor(full.to(mesh.device), mesh.device_mesh, placements,
                                 src_data_rank=None).to_local()
    t.copy_(full)
