"""Seeding (counterpart of mafed_tpu/core/prng.py::seed_everything)."""

from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators. The trainer's
    own randomness does not read them: memory selection and epoch orders use
    numpy Generators seeded from the config."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
