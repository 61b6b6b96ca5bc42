"""Continual-learning strategies (counterpart of mafed_tpu/cl): naive, EWC,
replay and featdistill (MAFED), by their CLI names."""

from mafed_tpu_torch.cl.base import CLStrategy, Naive
from mafed_tpu_torch.cl.distillation import FeatureDistillation
from mafed_tpu_torch.cl.ewc import EWC
from mafed_tpu_torch.cl.replay import ER

CLMethod = {
    "naive": Naive,
    "ewc": EWC,
    "replay": ER,
    "featdistill": FeatureDistillation,
}

__all__ = ["CLStrategy", "Naive", "EWC", "ER", "FeatureDistillation", "CLMethod"]
