#!/bin/bash
# PyTorch port: Stage-1 LLaVA projector pretrain (reference: scripts/v1_5/pretrain.sh).
# One process on one device; DEVICE=cpu runs the port on the CPU.
DEVICE=${DEVICE:-cuda}
python -m vcoder_tpu_torch.train.train --stage pretrain --version plain \
    --model-path ${MODEL_PATH:-checkpoints/vicuna-7b-v1.5-clip} \
    --output-dir ${OUTPUT_DIR:-checkpoints/llava-v1.5-7b-pretrain} \
    --data-path ${DATA_PATH:-playground/data/blip_laion_cc_sbu_558k.json} \
    --image-folder ${IMAGE_FOLDER:-playground/data} \
    --learning-rate 1e-3 \
    --num-train-epochs 1 \
    --per-device-train-batch-size ${BATCH_SIZE:-32} \
    --device $DEVICE \
    "$@"
