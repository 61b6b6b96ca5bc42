"""Command line of the port's continual-learning trainer (counterpart of
mafed_tpu/train.py):

    python -m mafed_tpu_torch.train --config config/train-vqa-base-cl-vlpythia.json \
        --output_dir out --cl_method featdistill --tasks action count ...

Flags are TrainConfig's fields; the JSON config fills every flag not given
on the command line. Runs on the CUDA device; --device cpu runs on the CPU.
Data parallel over N ranks, one device each (--batch_size is the global
batch):

    torchrun --nproc_per_node N -m mafed_tpu_torch.train --config ... [--device cpu]

where the default device is each rank's card, cuda:LOCAL_RANK. Tensor
parallel over a (data, model) grid of D x M ranks (core/mesh.py):

    torchrun --nproc_per_node D*M -m mafed_tpu_torch.train --config ... --mesh_shape D M

SIGTERM makes the run save a resume bundle at the next optimizer update and
exit with 143; the same command with --resume_from_checkpoint
<output_dir>/resume continues it. MAFED_PREEMPT_AFTER=N requests that exit
after N applied updates (a drill).
"""

from __future__ import annotations

import argparse
import os

from mafed_tpu_torch.core.config import build_arg_parser, parse_with_config
from mafed_tpu_torch.core.preempt import install_handlers, request_preemption_after
from mafed_tpu_torch.trainer.continual import ContinualLearningTrainer


def main(argv=None):
    install_handlers()
    if os.environ.get("MAFED_PREEMPT_AFTER"):
        request_preemption_after(int(os.environ["MAFED_PREEMPT_AFTER"]))
    device_parser = argparse.ArgumentParser(add_help=False)
    device_parser.add_argument("--device", default="cuda")
    known, rest = device_parser.parse_known_args(argv)
    config = parse_with_config(build_arg_parser(), rest)
    return ContinualLearningTrainer(config, device=known.device).main()


if __name__ == "__main__":
    main()
