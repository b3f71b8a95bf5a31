#!/bin/bash
# PyTorch port: Stage-2 VCoder adapter training (reference hyperparams:
# scripts/v1_5/vcoder_train.sh — lr 1e-3, cosine, warmup 0.03, bf16,
# 2 epochs, model_max_length 2048, grad ckpt, modality-grouped sampling).
# One process on one device; DEVICE=cpu runs the port on the CPU.
DEVICE=${DEVICE:-cuda}
python -m vcoder_tpu_torch.train.vcoder_train \
    --model-path ${MODEL_PATH:-checkpoints/llava-v1.5-7b} \
    --output-dir ${OUTPUT_DIR:-checkpoints/vcoder_llava-v1.5-7b} \
    --image-folder ${IMAGE_FOLDER:-playground/data} \
    --seg-data-path ${SEG_DATA_PATH:-playground/data/cost} \
    --learning-rate 1e-3 \
    --num-train-epochs 2 \
    --per-device-train-batch-size ${BATCH_SIZE:-32} \
    --warmup-ratio 0.03 \
    --model-max-length 2048 \
    --save-steps 1100 --save-total-limit 1 \
    --device $DEVICE \
    "$@"
