#!/bin/bash
# PyTorch port: VQAv2 (reference: scripts/v1_5/eval/vqav2.sh).
CKPT=${CKPT:-checkpoints/llava-v1.5-7b}
DEVICE=${DEVICE:-cuda}  # cpu runs the port on the CPU
SPLIT=${SPLIT:-llava_vqav2_mscoco_test-dev2015}
D=${D:-playground/data/eval/vqav2}
NAME=$(basename $CKPT)
python -m vcoder_tpu_torch.eval.vqa_loader \
    --model-path $CKPT \
    --question-file $D/$SPLIT.jsonl \
    --image-folder $D/test2015 \
    --answers-file $D/answers/$SPLIT/$NAME/merge.jsonl \
    --temperature 0 --conv-mode vicuna_v1 --device $DEVICE
python -m vcoder_tpu_torch.eval.converters vqav2 --dir $D --ckpt $NAME --split $SPLIT
