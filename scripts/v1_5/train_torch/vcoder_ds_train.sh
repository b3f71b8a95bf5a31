#!/bin/bash
# PyTorch port: Stage-3 VCoder-DS training: seg+depth adapters + vcoder_lm_emb over the
# six mixed data streams (reference: scripts/v1_5/vcoder_ds_train.sh).
# One process on one device; DEVICE=cpu runs the port on the CPU.
DEVICE=${DEVICE:-cuda}
python -m vcoder_tpu_torch.train.vcoder_ds_train \
    --model-path ${MODEL_PATH:-checkpoints/llava-v1.5-7b} \
    --output-dir ${OUTPUT_DIR:-checkpoints/vcoder_ds_llava-v1.5-7b} \
    --data-path ${DATA_PATH:-playground/data/llava_v1_5_mix665k.json} \
    --image-folder ${IMAGE_FOLDER:-playground/data} \
    --seg-data-path ${SEG_DATA_PATH:-playground/data/cost} \
    --depth-data-path ${DEPTH_DATA_PATH:-playground/data/cost} \
    --learning-rate 1e-3 \
    --num-train-epochs 1 \
    --per-device-train-batch-size ${BATCH_SIZE:-32} \
    --warmup-ratio 0.03 \
    --model-max-length 2048 \
    --save-steps 1100 --save-total-limit 1 \
    --device $DEVICE \
    "$@"
