"""VCoder-DS (seg + depth) stage: ``python -m vcoder_tpu_torch.train.vcoder_ds_train``.

Port of ``vcoder_tpu/train/vcoder_ds_train.py``; the flags are
``drivers.build_arg_parser``'s (reference: scripts/v1_5/vcoder_ds_train.sh).
"""

from vcoder_tpu_torch.train.drivers import build_arg_parser, run_stage


def main(argv=None):
    return run_stage("vcoder_ds", build_arg_parser().parse_args(argv))


if __name__ == "__main__":
    main()
