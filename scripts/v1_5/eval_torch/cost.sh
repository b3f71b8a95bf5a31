#!/bin/bash
# PyTorch port: COST seg evaluation: chunk fan-out + concat + CS/HS scorer
# (reference: scripts/v1_5/eval/cost.sh). CHUNKS > 1 starts that many
# processes, each on the card its CUDA_VISIBLE_DEVICES names.
CKPT=${CKPT:-checkpoints/vcoder_llava-v1.5-7b}
DEVICE=${DEVICE:-cuda}  # cpu runs the port on the CPU
DATA=${DATA:-playground/data/cost}
OUT=${OUT:-playground/data/eval/cost/$(basename $CKPT)}
CHUNKS=${CHUNKS:-1}

mkdir -p $OUT
for IDX in $(seq 0 $((CHUNKS-1))); do
  python -m vcoder_tpu_torch.eval.cost_loader \
      --model-path $CKPT \
      --image-folder $DATA/coco/val2017 \
      --use_seg \
      --seg-image-folder "$DATA/coco_segm_text/val/\$TASK_inference" \
      --output-file $OUT/output \
      --num-chunks $CHUNKS --chunk-idx $IDX \
      --temperature 0 --conv-mode vicuna_v1 --device $DEVICE &
done
wait

# Concatenate the per-chunk files (reference naming contract:
# output_{task}_{CHUNKS}_{IDX}.txt).
for TASK in semantic instance panoptic; do
  > $OUT/output_${TASK}.txt
  for IDX in $(seq 0 $((CHUNKS-1))); do
    cat $OUT/output_${TASK}_${CHUNKS}_${IDX}.txt >> $OUT/output_${TASK}.txt
  done
done

python -m vcoder_tpu_torch.eval.seg_accuracy \
    --gt_path $DATA/coco_segm_text/val --pred_path $OUT
