"""LLaVA base-stage entry point: ``python -m vcoder_tpu_torch.train.train``.

Port of ``vcoder_tpu/train/train.py``. ``--stage pretrain`` trains the
projector alone with the plain conversation version; ``--stage full`` is
the full finetune, with ``--lora-enable`` its LoRA variant (reference:
scripts/v1_5/{pretrain,finetune,finetune_lora}.sh).
"""

from vcoder_tpu_torch.train.drivers import build_arg_parser, run_stage


def build_parser():
    parser = build_arg_parser()
    parser.add_argument("--stage", type=str, default="full", choices=["pretrain", "full"])
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.stage == "pretrain" and args.version == "v1":
        args.version = "plain"
    return run_stage(args.stage, args)


if __name__ == "__main__":
    main()
