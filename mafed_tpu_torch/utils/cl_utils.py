"""CL helpers (copy of mafed_tpu/utils/cl_utils.py): a random task order is
the seeded shuffle of the split file's task keys."""

from __future__ import annotations

import json
import random
from typing import List, Optional


def random_task_order(exp: str, split_file: str, seed: Optional[int] = None) -> List[str]:
    with open(split_file) as fp:
        tasks = list(json.load(fp).keys())
    rng = random.Random(seed)
    rng.shuffle(tasks)
    return tasks
