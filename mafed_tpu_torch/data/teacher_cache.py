"""Cache of the distillation teacher's hidden states (counterpart of
mafed_tpu/data/teacher_cache.py).

The MAFED teacher is frozen for a whole task (a copy of the previous task's
best model) and the replay memory it reads is a fixed set, collated to one
text length, so a memory example's teacher states never change within a
task, yet the in-step teacher recomputes them at every draw. After the
teacher changes at a task transition, `prime_teacher_cache` computes them
once per memory example (batched, early-exited at the deepest distilled
tap, its attention through the flash forward kernel on the card) and the
distill step takes them from the batch ("t_hs" [B, n_states, T, H] bf16):
the teacher forward leaves the step.

Two tiers: `DeviceTeacherTable` holds the whole memory set's states on the
card (memory batches carry 4-byte "t_idx" rows) when they fit
device_teacher_table_mb; otherwise `TeacherStateView` streams them from
disk, one [n_states, seq, hidden] file per example under base_dir/gen{g}/
(the port's bf16-bits files, data/diskcache.py), with only the live
teacher's generation kept. The policy between them is cl/distillation.py's.
Several ranks prime one shared directory together, each the examples it
owns (`shard_owner`), and wait for each other before any reads it. A
tensor-parallel teacher is gathered first, as the JAX package localizes
it (mafed_tpu/data/teacher_cache.py:345-347): each rank then computes its
examples alone, with no collective in its forwards, on a full copy.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List

import torch

from mafed_tpu_torch.core.dist import barrier, process_count, process_index
from mafed_tpu_torch.data.diskcache import ArrayDiskCache, params_fingerprint, set_fingerprint_coordinated, shard_owner
from mafed_tpu_torch.data.images import make_normalizer, prep_pixels
from mafed_tpu_torch.data.prefetch import to_device
from mafed_tpu_torch.data.vision_table import gather_rows
from mafed_tpu_torch.data.vqa_dataset import question_id_of
from mafed_tpu_torch.evaluation.validate import gather_to_replicated
from mafed_tpu_torch.models import vl_pythia


def resolve_teacher_cache_mode(value) -> str:
    """--teacher_state_cache as one of "off" / "auto" / "on"; bools and
    their spellings stay valid (True, "1", "true" mean "on")."""
    if isinstance(value, bool):
        return "on" if value else "off"
    mode = str(value).strip().lower()
    if mode in ("1", "true", "yes"):
        return "on"
    if mode in ("0", "false", "no", "none", ""):
        return "off"
    if mode not in ("off", "auto", "on"):
        raise ValueError(f"teacher_state_cache must be off/auto/on, got {value!r}")
    return mode


class TeacherStateCache(ArrayDiskCache):
    """One [n_states, seq_len, hidden] entry (seq = vision ++ text) per
    (teacher generation, question_id), under base_dir/gen{g}/, stamped with
    the teacher's fingerprint at priming."""

    def __init__(self, base_dir: str, generation: int, n_states: int, seq_len: int, hidden: int) -> None:
        super().__init__(os.path.join(base_dir, f"gen{generation}"), (n_states, seq_len, hidden))
        self.base_dir = base_dir
        self.generation = generation

    # question ids may be ints (VQA-v2): keyed by their string form
    def has(self, qid) -> bool:
        return super().has(str(qid))

    def load(self, qid):
        return super().load(str(qid))

    def save(self, qid, states: torch.Tensor) -> None:
        super().save(str(qid), states)

    def drop_older_generations(self) -> None:
        """Keep disk use to the live teacher: delete the gen dirs before this one."""
        if not os.path.isdir(self.base_dir):
            return
        for name in os.listdir(self.base_dir):
            if name.startswith("gen") and name[3:].isdigit() and int(name[3:]) < self.generation:
                shutil.rmtree(os.path.join(self.base_dir, name), ignore_errors=True)


class DeviceTeacherTable:
    """The memory set's teacher states on `device`, bf16 [n_mem, n_states,
    seq, hidden]; `resolve` turns a batch's "t_idx" into "t_hs" with one
    gather on the card."""

    def __init__(self, states: torch.Tensor, key_to_idx: Dict[str, int], device="cpu") -> None:
        self.key_to_idx = key_to_idx
        self.table = states.to(device, torch.bfloat16)
        self.nbytes = self.table.numel() * 2

    def __len__(self) -> int:
        return len(self.key_to_idx)

    def index(self, qid) -> int:
        return self.key_to_idx[str(qid)]

    def resolve(self, batch: Dict) -> Dict:
        if "t_idx" not in batch:
            return batch
        out = dict(batch)
        out["t_hs"] = gather_rows(self.table, out.pop("t_idx"))
        return out


def teacher_table_nbytes(n_mem: int, n_states: int, seq_len: int, hidden: int) -> int:
    return n_mem * n_states * seq_len * hidden * 2  # bf16


def build_teacher_table(cache: TeacherStateCache, qids: List, device="cpu") -> DeviceTeacherTable:
    """The table of `qids` from a primed cache (a miss is an error)."""
    if not qids:
        raise ValueError("empty teacher table")
    states = torch.empty((len(qids),) + tuple(cache.expected_shape), dtype=torch.bfloat16)
    for i, q in enumerate(qids):
        arr = cache.load(q)
        if arr is None:
            raise RuntimeError(f"teacher table: cache miss for {q!r} (prime first)")
        states[i] = arr
    return DeviceTeacherTable(states, {str(q): i for i, q in enumerate(qids)}, device=device)


class TeacherIndexView:
    """A memory dataset whose items carry their teacher-table row ("t_idx")."""

    def __init__(self, dataset, table: DeviceTeacherTable) -> None:
        self.dataset = dataset
        self.table = table

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int) -> Dict:
        item = self.dataset[index]
        item["t_idx"] = self.table.index(item.get("question_id"))
        return item

    def question_id(self, index: int):
        return question_id_of(self.dataset, index)


class TeacherStateView:
    """A memory dataset whose items carry their cached teacher states ("t_hs");
    a miss leaves the item without them (and collate refuses the batch)."""

    def __init__(self, dataset, cache: TeacherStateCache) -> None:
        self.dataset = dataset
        self.cache = cache

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int) -> Dict:
        item = self.dataset[index]
        t_hs = self.cache.load(item.get("question_id"))
        if t_hs is not None:
            item["t_hs"] = t_hs
        return item

    def question_id(self, index: int):
        return question_id_of(self.dataset, index)


def teacher_seq_len(model_cfg, text_len: int) -> int:
    """Length of the hidden states the cache holds: vision tokens ++ text."""
    return vl_pythia.n_vision_tokens(model_cfg) + text_len


def teacher_fingerprint(teacher) -> str:
    """The digest binding a cache generation to the teacher (decoder,
    projector and the frozen tower) whose states it holds: every floating
    tensor cast to bf16 first, so an f32 reload of the same weights stamps
    alike and a restart does not re-prime."""
    tensors = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in teacher.state_dict().items()}
    return "teacher:" + params_fingerprint(tensors)


def prime_teacher_cache(cache: TeacherStateCache, dataset, teacher, collate, deepest_tap: int,
                        batch_size: int = 16, vision_table=None) -> int:
    """Compute and store the teacher states of every memory example the cache
    lacks: one bf16 forward early-exited at `deepest_tap` a batch. The JAX
    package pads the last batch to its compiled size; here it runs short.
    The cache is stamped with the teacher first. Over several ranks, each
    computes the examples it owns, then waits for the others. Returns the
    number of examples this rank computed (0 on a warm cache). A
    tensor-parallel teacher is gathered first (every rank calls this)."""
    teacher = gather_to_replicated(teacher)
    set_fingerprint_coordinated(cache, teacher_fingerprint(teacher))

    todo: List[int] = []
    qids: List = []
    seen: set = set()
    for i in range(len(dataset)):
        qid = question_id_of(dataset, i)  # metadata only: no image or feature load
        if qid is None:
            raise ValueError(
                "teacher-state cache requires a question_id per memory example; annotations without ids "
                "would all collapse onto one cache entry (disable --teacher_state_cache)"
            )
        if str(qid) in seen:
            raise ValueError(
                f"duplicate question_id {qid!r} in the memory set: ids must be unique across tasks or cached "
                "teacher states would be served across examples (disable --teacher_state_cache)"
            )
        seen.add(str(qid))
        if not cache.has(qid) and shard_owner(qid, process_count()) == process_index():
            todo.append(i)
            qids.append(qid)
    if todo:
        _compute_states(cache, dataset, todo, qids, teacher, collate, deepest_tap, batch_size, vision_table)
    barrier("teacher_cache_primed")  # also where this rank owned nothing: no rank reads a half-primed cache
    return len(todo)


def _compute_states(cache: TeacherStateCache, dataset, todo: List[int], qids: List, teacher, collate,
                    deepest_tap: int, batch_size: int, vision_table) -> None:
    device = next(teacher.parameters()).device
    normalize = make_normalizer(teacher.cfg.vision)
    for start in range(0, len(todo), batch_size):
        batch = collate([dataset[i] for i in todo[start : start + batch_size]])
        if "patch_idx" in batch:
            if vision_table is None:
                raise RuntimeError("memory batch carries vision-table rows but no table was passed")
            batch = vision_table.resolve_host(batch)
        batch = to_device(batch, device)
        with torch.inference_mode():
            if "patches" in batch:
                patches = batch["patches"].to(torch.bfloat16)
            else:
                patches = vl_pythia.get_patch_embeddings(teacher, prep_pixels(batch, normalize, torch.bfloat16))
            hs = vl_pythia.forward(
                teacher, batch["input_ids"], batch["attention_mask"], None, patch_embeddings=patches,
                output_hidden_states=True, dtype=torch.bfloat16, need_logits=False, num_layers=deepest_tap,
            ).hidden_states
            hs = hs.transpose(0, 1).cpu()  # [B, n_states, T, H]
        for qid, states in zip(qids[start : start + batch_size], hs):
            cache.save(qid, states)
