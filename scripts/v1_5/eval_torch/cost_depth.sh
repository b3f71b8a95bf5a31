#!/bin/bash
# PyTorch port: COST depth-order evaluation (reference: scripts/v1_5/eval/cost_depth.sh).
CKPT=${CKPT:-checkpoints/vcoder_ds_llava-v1.5-7b}
DEVICE=${DEVICE:-cuda}  # cpu runs the port on the CPU
DATA=${DATA:-playground/data/cost}
OUT=${OUT:-playground/data/eval/cost_depth/$(basename $CKPT)}
mkdir -p $OUT
python -m vcoder_tpu_torch.eval.cost_loader \
    --model-path $CKPT \
    --image-folder $DATA/coco/val2017 \
    --use_seg --seg-image-folder "$DATA/coco_segm_text/val/panoptic_inference" \
    --use_depth --depth-image-folder "$DATA/coco_segm_text/depth/val/depth" \
    --output-file $OUT/output --tasks depth --temperature 0 --conv-mode vicuna_v1 --device $DEVICE
mv $OUT/output_depth_1_0.txt $OUT/output_depth.txt
python -m vcoder_tpu_torch.eval.depth_accuracy \
    --gt_path $DATA/coco_segm_text/depth/val/panoptic_order.txt \
    --pred_path $OUT/output_depth.txt
