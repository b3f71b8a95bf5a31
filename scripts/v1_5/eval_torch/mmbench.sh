#!/bin/bash
# PyTorch port: MMBench (reference: scripts/v1_5/eval/mmbench.sh).
CKPT=${CKPT:-checkpoints/llava-v1.5-7b}
DEVICE=${DEVICE:-cuda}  # cpu runs the port on the CPU
SPLIT=${SPLIT:-mmbench_dev_20230712}
D=${D:-playground/data/eval/mmbench}
python -m vcoder_tpu_torch.eval.mmbench_loader \
    --model-path $CKPT \
    --question-file $D/$SPLIT.tsv \
    --answers-file $D/answers/$SPLIT/$(basename $CKPT).jsonl \
    --single-pred-prompt --temperature 0 --conv-mode vicuna_v1 --device $DEVICE
python -m vcoder_tpu_torch.eval.converters mmbench \
    --annotation-file $D/$SPLIT.tsv \
    --result-dir $D/answers/$SPLIT \
    --upload-dir $D/answers_upload/$SPLIT \
    --experiment $(basename $CKPT)
