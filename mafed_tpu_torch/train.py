"""Command line of the port's continual-learning trainer (counterpart of
mafed_tpu/train.py):

    python -m mafed_tpu_torch.train --config config/train-vqa-base-cl-vlpythia.json \
        --output_dir out --cl_method featdistill --tasks action count ... \
        --device_vision_table_mb 0 --teacher_state_cache off

Flags are TrainConfig's fields; the JSON config fills every flag not given
on the command line. Runs on the CUDA device; --device cpu runs on the CPU.
"""

from __future__ import annotations

import argparse

from mafed_tpu_torch.core.config import build_arg_parser, parse_with_config
from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer


def main(argv=None):
    device_parser = argparse.ArgumentParser(add_help=False)
    device_parser.add_argument("--device", default="cuda")
    known, rest = device_parser.parse_known_args(argv)
    config = parse_with_config(build_arg_parser(), rest)
    return ContinualLearningTrainer(config, device=known.device).main()


if __name__ == "__main__":
    main()
