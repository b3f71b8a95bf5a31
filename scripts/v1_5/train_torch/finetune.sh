#!/bin/bash
# PyTorch port: Stage-2 LLaVA full finetune (reference: scripts/v1_5/finetune.sh, lr 2e-5).
# One process on one device; DEVICE=cpu runs the port on the CPU.
# Memory-tight cards: add --offload-opt-state (the zero3_offload.json
# analog -- the Adam moments pinned in host memory, streamed per step).
# 13B: MODEL_PATH=<a llava-v1.5-13b base> BATCH_SIZE=2 with --offload-opt-state on one
# card, or under torchrun (--nproc-per-node 4 ... --mesh-fsdp 4 --offload-opt-state).
DEVICE=${DEVICE:-cuda}
python -m vcoder_tpu_torch.train.train --stage full \
    --model-path ${MODEL_PATH:-checkpoints/llava-v1.5-7b-pretrain} \
    --output-dir ${OUTPUT_DIR:-checkpoints/llava-v1.5-7b} \
    --data-path ${DATA_PATH:-playground/data/llava_v1_5_mix665k.json} \
    --image-folder ${IMAGE_FOLDER:-playground/data} \
    --learning-rate 2e-5 \
    --num-train-epochs 1 \
    --per-device-train-batch-size ${BATCH_SIZE:-16} \
    --device $DEVICE \
    "$@"
