"""VCoder-IT stage: ``python -m vcoder_tpu_torch.train.vcoder_it``
(``--lora-enable`` for its LoRA variant).

Port of ``vcoder_tpu/train/vcoder_it.py``; the flags are
``drivers.build_arg_parser``'s (reference: scripts/v1_5/vcoder_it.sh,
vcoder_it_lora.sh).
"""

from vcoder_tpu_torch.train.drivers import build_arg_parser, run_stage


def main(argv=None):
    return run_stage("it", build_arg_parser().parse_args(argv))


if __name__ == "__main__":
    main()
