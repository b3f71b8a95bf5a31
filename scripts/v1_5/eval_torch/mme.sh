#!/bin/bash
# PyTorch port: MME (reference: scripts/v1_5/eval/mme.sh). Scoring is self-contained:
# eval/mme_eval.py implements the MME eval_tool's calculation semantics.
CKPT=${CKPT:-checkpoints/llava-v1.5-7b}
DEVICE=${DEVICE:-cuda}  # cpu runs the port on the CPU
D=${D:-playground/data/eval/MME}
NAME=$(basename $CKPT)
python -m vcoder_tpu_torch.eval.vqa_loader \
    --model-path $CKPT \
    --question-file $D/llava_mme.jsonl \
    --image-folder $D/MME_Benchmark_release_version \
    --answers-file $D/answers/$NAME.jsonl \
    --temperature 0 --conv-mode vicuna_v1 --device $DEVICE
python -m vcoder_tpu_torch.eval.converters mme \
    --question-file $D/llava_mme.jsonl \
    --result-file $D/answers/$NAME.jsonl \
    --benchmark-dir $D/MME_Benchmark_release_version \
    --output-dir $D/eval_tool/answers/$NAME
python -m vcoder_tpu_torch.eval.mme_eval --results_dir $D/eval_tool/answers/$NAME
