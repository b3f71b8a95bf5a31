#!/bin/bash
# PyTorch port: VizWiz (reference: scripts/v1_5/eval/vizwiz.sh).
CKPT=${CKPT:-checkpoints/llava-v1.5-7b}
DEVICE=${DEVICE:-cuda}  # cpu runs the port on the CPU
D=${D:-playground/data/eval/vizwiz}
NAME=$(basename $CKPT)
python -m vcoder_tpu_torch.eval.vqa_loader \
    --model-path $CKPT \
    --question-file $D/llava_test.jsonl \
    --image-folder $D/test \
    --answers-file $D/answers/$NAME.jsonl \
    --temperature 0 --conv-mode vicuna_v1 --device $DEVICE
python -m vcoder_tpu_torch.eval.converters vizwiz \
    --annotation-file $D/llava_test.jsonl \
    --result-file $D/answers/$NAME.jsonl \
    --result-upload-file $D/answers_upload/$NAME.json
