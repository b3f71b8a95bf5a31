#!/bin/bash
# PyTorch port: VCoder-IT training: seg projector (bootstrapped from mm_projector) + the
# full LLM over COST instruction data (reference: scripts/v1_5/vcoder_it.sh
# — lr 2e-5, cosine, warmup 0.03, bf16, 1 epoch, save_steps 5000).
# One process on one device; DEVICE=cpu runs the port on the CPU.
DEVICE=${DEVICE:-cuda}
python -m vcoder_tpu_torch.train.vcoder_it \
    --model-path ${MODEL_PATH:-checkpoints/llava-v1.5-7b} \
    --output-dir ${OUTPUT_DIR:-outputs/vcoder_it_llava-v1.5-7b} \
    --data-path ${DATA_PATH:-playground/data/llava_v1_5_mix665k.json} \
    --image-folder ${IMAGE_FOLDER:-playground/data} \
    --seg-data-path ${SEG_DATA_PATH:-playground/data/cost} \
    --learning-rate 2e-5 \
    --num-train-epochs 1 \
    --per-device-train-batch-size ${BATCH_SIZE:-16} \
    --warmup-ratio 0.03 \
    --model-max-length 2048 \
    --save-steps 5000 --save-total-limit 1 \
    --device $DEVICE \
    "$@"
