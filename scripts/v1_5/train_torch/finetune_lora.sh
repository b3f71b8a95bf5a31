#!/bin/bash
# PyTorch port: Stage-2 LLaVA LoRA finetune (reference: scripts/v1_5/finetune_lora.sh —
# lora_r 128, lora_alpha 256, lr 2e-4, cosine, warmup 0.03, bf16, 1 epoch).
# One process on one device; DEVICE=cpu runs the port on the CPU.
DEVICE=${DEVICE:-cuda}
python -m vcoder_tpu_torch.train.train --stage full \
    --lora-enable --lora-r 128 --lora-alpha 256 \
    --model-path ${MODEL_PATH:-checkpoints/llava-v1.5-13b-pretrain} \
    --output-dir ${OUTPUT_DIR:-checkpoints/llava-v1.5-13b-lora} \
    --data-path ${DATA_PATH:-playground/data/llava_v1_5_mix665k.json} \
    --image-folder ${IMAGE_FOLDER:-playground/data} \
    --learning-rate 2e-4 \
    --num-train-epochs 1 \
    --per-device-train-batch-size ${BATCH_SIZE:-16} \
    --model-max-length 2048 \
    --save-steps 50000 --save-total-limit 1 \
    --device $DEVICE \
    "$@"
