"""Stage training drivers (port of ``vcoder_tpu/train/drivers.py:23-264``).

One argparse CLI per stage mirrors the flags of the reference launch
scripts (scripts/v1_5/{pretrain,finetune,finetune_lora,vcoder_train,
vcoder_ds_train,vcoder_it,vcoder_it_lora}.sh)::

    python -m vcoder_tpu_torch.train.vcoder_train    --model-path ... --seg-data-path ...
    python -m vcoder_tpu_torch.train.vcoder_ds_train --model-path ... ...

:func:`run_stage` loads the base checkpoint, upgrades its config to the
stage's model variant and adds the adapter branches a plain LLaVA base
lacks (``models/vcoder.py::initialize_missing_modules``, whose random
projectors come from a ``torch.Generator`` seeded with ``--seed``: other
numbers than JAX's), wraps every decoder linear in fresh adapters for
``--lora-enable`` (under torchrun too: the adapters drawn whole, then
sharded; ``final/`` merged a layer at a time once the optimizer state
is released), builds the stage's COST / LLaVA-mix streams
(``train/datasets.py``), trains through ``Trainer`` (resuming from the
newest ``checkpoint-*``), then writes a step checkpoint,
``adapters.safetensors`` and ``final/`` (LoRA merged) with the tokenizer.

Under torchrun (``python -m torch.distributed.run --nproc-per-node N -m
vcoder_tpu_torch.train.vcoder_ds_train ...``) every rank joins the process
group (``parallel/launch.py``) and trains over a mesh of the group's ranks
built by ``--mesh-data/--mesh-fsdp/--mesh-model`` with JAX's rule (every
rank on ``fsdp`` by default, ``drivers.py:72-75,208-236``); rank 0 writes
the outputs. A plain ``python -m`` call runs on one device, ``--device``
(CUDA unless ``cpu``), over a one-device mesh entered with ``use_mesh``
(JAX's mesh would take every visible device); there a mesh product above 1
raises a ``ValueError`` that names torchrun. ``--offload-opt-state`` keeps
the optimizer state in pinned host memory, streamed through the card each
step (the zero3_offload analog; ``train/step.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # model
    p.add_argument("--model-path", type=str, required=True,
                   help="base checkpoint dir (e.g. imported llava-v1.5-7b)")
    p.add_argument("--version", type=str, default="v1")
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    # data
    p.add_argument("--data-path", type=str, default=None,
                   help="LLaVA-mix json (stage-3 streams)")
    p.add_argument("--image-folder", type=str, default="")
    p.add_argument("--seg-data-path", type=str, default="",
                   help="COST root with coco_segm_text/")
    p.add_argument("--depth-data-path", type=str, default="")
    p.add_argument("--image-aspect-ratio", type=str, default="pad")
    p.add_argument("--group-by-modality-length", action=argparse.BooleanOptionalAction,
                   default=True)
    # optimization (reference: scripts/v1_5/vcoder_train.sh)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--num-train-epochs", type=int, default=2)
    p.add_argument("--per-device-train-batch-size", type=int, default=4)
    p.add_argument("--gradient-accumulation-steps", type=int, default=1)
    p.add_argument("--warmup-ratio", type=float, default=0.03)
    p.add_argument("--weight-decay", type=float, default=0.0)
    p.add_argument("--model-max-length", type=int, default=2048)
    p.add_argument("--save-steps", type=int, default=1100)
    p.add_argument("--save-total-limit", type=int, default=1)
    p.add_argument("--logging-steps", type=int, default=1)
    p.add_argument("--gradient-checkpointing", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max-steps", type=int, default=None)
    # LoRA (reference: scripts/v1_5/finetune_lora.sh, vcoder_it_lora.sh --
    # lora_r 128, lora_alpha 256; adapters over every LM linear)
    p.add_argument("--lora-enable", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--lora-r", type=int, default=128)
    p.add_argument("--lora-alpha", type=float, default=256.0)
    # mesh (a product above 1 needs torchrun: one process per device)
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-fsdp", type=int, default=None)
    p.add_argument("--mesh-model", type=int, default=None)
    # zero3_offload analog: the optimizer state in host memory
    p.add_argument("--offload-opt-state", action=argparse.BooleanOptionalAction,
                   default=False)
    return p


# The model variant each stage trains (``drivers.py:103-109``).
STAGE_MODEL_TYPE = {
    "pretrain": "llava",
    "full": "llava",
    "vcoder": "vcoder_llava",
    "vcoder_ds": "vcoder_ds_llava",
    "it": "vcoder_it_llava",
}


def stage_mesh(args):
    """The stage's mesh and this process's device: over the torchrun group
    when there is one, else the one ``--device``, where a mesh product above
    1 raises."""
    from vcoder_tpu_torch.parallel import launch, make_mesh

    device = getattr(args, "device", "cuda")
    sizes = dict(data=args.mesh_data, fsdp=args.mesh_fsdp, model=args.mesh_model)
    if launch.in_torchrun():
        device = launch.init_distributed(device)
        return make_mesh(**sizes), device
    product = 1
    for v in sizes.values():
        product *= v or 1
    if product > 1:
        raise ValueError(
            f"--mesh-data/--mesh-fsdp/--mesh-model {sizes}: a mesh of {product} devices runs "
            "one process per device; launch the stage with python -m torch.distributed.run "
            "--nproc-per-node N")
    # The one --device (JAX's mesh takes every visible device).
    return make_mesh([device], **sizes), device


def build_entries(stage: str, args):
    """The stage's entry list and its (use_seg, use_depth) (``:158-199``)."""
    from vcoder_tpu_torch.train.datasets import (
        build_seg_cost_entries,
        get_depth_data_split,
        get_extra_count_data_split,
        obtain_seg_data_splits,
        obtain_seg_depth_data_splits,
    )

    seed = args.seed
    depth_root = args.depth_data_path or args.seg_data_path
    if stage in ("pretrain", "full"):
        # LLaVA stage-1/2: a json of {conversations, image?}.
        with open(args.data_path) as f:
            return json.load(f), False, False
    if stage in ("vcoder", "it"):
        return build_seg_cost_entries(args.seg_data_path, seed=seed), True, False
    if stage != "vcoder_ds":
        raise ValueError(f"unknown stage {stage}")
    entries = []
    if args.data_path:
        entries += obtain_seg_data_splits(args.data_path, args.image_folder,
                                          args.seg_data_path, seed=seed)
        entries += obtain_seg_depth_data_splits(args.data_path, args.image_folder, depth_root,
                                                seed=seed + 1)
    entries += build_seg_cost_entries(args.seg_data_path, seed=seed + 2, with_depth=True)
    entries += build_seg_cost_entries(args.seg_data_path, seed=seed + 3)
    entries += get_depth_data_split(depth_root, seed=seed + 4)
    entries += get_extra_count_data_split(args.seg_data_path, seed=seed + 5)
    return entries, True, True


def build_dataset(stage: str, args, tokenizer, cfg):
    """The stage's ``VCoderDataset`` over :func:`build_entries`, as
    :func:`run_stage` trains on it."""
    from vcoder_tpu_torch.train.datasets import VCoderDataset

    entries, use_seg, use_depth = build_entries(stage, args)
    return VCoderDataset(
        entries,
        tokenizer,
        image_folder=args.image_folder,
        seg_data_path=args.seg_data_path,
        depth_data_path=args.depth_data_path or args.seg_data_path,
        image_size=cfg.vision.image_size,
        image_aspect_ratio=args.image_aspect_ratio,
        version=args.version,
        model_max_length=args.model_max_length,
        use_seg=use_seg,
        use_depth=use_depth,
    )


def run_stage(stage: str, args):
    """Train one stage from ``args`` (:func:`build_arg_parser`'s) and write
    its outputs under ``args.output_dir``. Returns the ``Trainer``."""
    import torch

    from vcoder_tpu_torch import builder
    from vcoder_tpu_torch.checkpoint import save_pretrained
    from vcoder_tpu_torch.config import _variant_flags
    from vcoder_tpu_torch.models.vcoder import initialize_missing_modules
    from vcoder_tpu_torch.parallel import use_mesh
    from vcoder_tpu_torch.parallel.mesh import rank_zero
    from vcoder_tpu_torch.parallel.sharding import leaf_sharder
    from vcoder_tpu_torch.train.trainer import TrainArgs, Trainer

    mesh, device = stage_mesh(args)
    # Over a process group each leaf is sharded as it is loaded.
    tokenizer, model, *_ = builder.load_pretrained_model(args.model_path, device=device,
                                                         place=leaf_sharder(mesh))
    cfg = model.config
    if tokenizer is None:
        raise SystemExit("model-path must contain tokenizer files (or a vcoder_tokenizer.json)")

    # Upgrade the config to the stage's variant and add the adapter branches
    # a plain LLaVA base lacks (the reference's initialize_*_modules calls).
    target_type = STAGE_MODEL_TYPE[stage]
    if cfg.model_type != target_type and target_type != "llava":
        cfg = dataclasses.replace(cfg, model_type=target_type, **_variant_flags(target_type))
        model.params = initialize_missing_modules(model.params, cfg, seed=args.seed)
        model.config = cfg

    # LoRA stages wrap every decoder linear in fresh adapters and train only
    # their a/b leaves (+ the stage's projector): step.STAGE_TRAINABLE.
    train_stage = stage
    lora_enable = bool(getattr(args, "lora_enable", False))
    if lora_enable:
        if stage not in ("full", "it"):
            raise SystemExit(
                "--lora-enable applies to the full-finetune and it stages "
                "(reference: scripts/v1_5/finetune_lora.sh, vcoder_it_lora.sh)"
            )
        from vcoder_tpu_torch.lora import add_lora

        # Each A is drawn whole from one seeded generator, as on one device;
        # over a process group each wrapper is then sharded before the next.
        emb = model.params["lm"]["embed_tokens"]
        gen = torch.Generator(device=emb.device)
        gen.manual_seed(args.seed + 17)
        model.params = add_lora(model.params, gen, rank=args.lora_r, alpha=args.lora_alpha,
                                place=leaf_sharder(mesh))
        train_stage = "lora" if stage == "full" else "it_lora"

    dataset = build_dataset(stage, args, tokenizer, cfg)
    targs = TrainArgs(
        output_dir=args.output_dir,
        stage=train_stage,
        learning_rate=args.learning_rate,
        num_train_epochs=args.num_train_epochs,
        per_device_train_batch_size=args.per_device_train_batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        warmup_ratio=args.warmup_ratio,
        weight_decay=args.weight_decay,
        logging_steps=args.logging_steps,
        save_steps=args.save_steps,
        save_total_limit=args.save_total_limit,
        model_max_length=args.model_max_length,
        group_by_modality_length=args.group_by_modality_length,
        seed=args.seed,
        # --gradient-checkpointing selects the "dots" policy (save the
        # projection products, recompute the rest).
        remat="dots" if args.gradient_checkpointing else False,
        offload_opt_state=args.offload_opt_state,
    )
    with use_mesh(mesh):
        trainer = Trainer(cfg, model.params, dataset, targs, mesh=mesh, device=device)
        if trainer.maybe_resume():
            print(f"Resumed from step {trainer.step}")
        trainer.train(max_steps=args.max_steps)
        trainer.save_checkpoint()
        trainer.save_adapters()

        final_params = trainer.params
        if lora_enable:
            # Fold the adapters into dense weights so final/ is a plain
            # checkpoint; adapters.safetensors keeps the unmerged a/b leaves.
            # The optimizer state goes first: the merged tree is a second
            # copy of the decoder's linears.
            from vcoder_tpu_torch.lora import merge_lora

            trainer.release_state()
            final_params = merge_lora(final_params)
        final = os.path.join(args.output_dir, "final")
        save_pretrained(final, final_params, cfg)
        if hasattr(tokenizer, "save_pretrained") and rank_zero():
            tokenizer.save_pretrained(final)
    if rank_zero():
        print("training complete:", args.output_dir)
    return trainer
