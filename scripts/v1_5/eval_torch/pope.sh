#!/bin/bash
# PyTorch port: POPE benchmark (reference: scripts/v1_5/eval/pope.sh).
CKPT=${CKPT:-checkpoints/llava-v1.5-7b}
DEVICE=${DEVICE:-cuda}  # cpu runs the port on the CPU
D=${D:-playground/data/eval/pope}
python -m vcoder_tpu_torch.eval.vqa_loader \
    --model-path $CKPT \
    --question-file $D/llava_pope_test.jsonl \
    --image-folder $D/val2014 \
    --answers-file $D/answers/$(basename $CKPT).jsonl \
    --temperature 0 --conv-mode vicuna_v1 --device $DEVICE
python -m vcoder_tpu_torch.eval.pope \
    --annotation-dir $D/coco \
    --question-file $D/llava_pope_test.jsonl \
    --result-file $D/answers/$(basename $CKPT).jsonl
