#!/bin/bash
# PyTorch port: GQA (reference: scripts/v1_5/eval/gqa.sh).
CKPT=${CKPT:-checkpoints/llava-v1.5-7b}
DEVICE=${DEVICE:-cuda}  # cpu runs the port on the CPU
SPLIT=${SPLIT:-llava_gqa_testdev_balanced}
D=${D:-playground/data/eval/gqa}
NAME=$(basename $CKPT)
python -m vcoder_tpu_torch.eval.vqa_loader \
    --model-path $CKPT \
    --question-file $D/$SPLIT.jsonl \
    --image-folder $D/data/images \
    --answers-file $D/answers/$SPLIT/$NAME.jsonl \
    --temperature 0 --conv-mode vicuna_v1 --device $DEVICE
python -m vcoder_tpu_torch.eval.converters gqa \
    --src $D/answers/$SPLIT/$NAME.jsonl \
    --dst $D/data/testdev_balanced_predictions.json
python -m vcoder_tpu_torch.eval.gqa_eval \
    --questions $D/data/testdev_balanced_questions.json \
    --predictions $D/data/testdev_balanced_predictions.json \
    ${CHOICES:+--choices $CHOICES}
