"""Data parallelism over torch.distributed (counterpart of
mafed_tpu/core/dist.py): joining the process group, the rank queries,
barriers, the host-scalar sum of the metric states, and the coalesced
collectives of the gradient step.

Each rank drives one device. A run of N ranks is launched the PyTorch way,

    torchrun --nproc_per_node N -m mafed_tpu_torch.train ...

whose RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT take the
place of the JAX package's coordinator address. The backend is NCCL for
CUDA ranks and gloo for CPU ranks unless the caller names one; nothing
switches backend when a launch fails. The host scalars (metric sums, the
preemption vote, equality checks) go over a gloo group of their own, so
that under NCCL they never wait for the card. A single process touches
nothing: every collective here is the identity on one rank.

Tensor parallelism (core/mesh.py) lays the ranks out as a (data, model)
grid; `make_mesh` installs its groups here (`set_layout`). Each collective
takes a `group`: None is every rank, `data_group()` the ranks that hold the
same shards and split the rows, `model_group()` the ranks that split the
weights and see the same rows. Without a mesh the layout is 1-D: the data
group is every rank and the model group this rank alone.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import torch
import torch.distributed as dist

from mafed_tpu_torch.core.logging import LOGGER

_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_HOST_GROUP = None  # the gloo group of the host collectives when the default group is NCCL
_LAYOUT = None  # (data group, model group) of the mesh core/mesh.make_mesh built, None: 1-D


@dataclass(frozen=True)
class Group:
    """Ranks that run collectives together: their global ranks in order,
    this rank's place among them, the torch process group (None: the
    default group of every rank) and the gloo group of its host values
    (None: `host_group()`). Copying a model that holds one keeps it."""

    ranks: Tuple[int, ...]
    index: int
    group: Any = None
    host: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    def __copy__(self) -> "Group":
        return self

    def __deepcopy__(self, memo) -> "Group":
        return self


def _launched_world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def maybe_initialize_distributed(config=None, backend: Optional[str] = None, device=None) -> bool:
    """Join the process group when config.distributed_init is set or the
    launcher says WORLD_SIZE > 1; returns whether a group exists after the
    call. A second call returns True and leaves the group alone; a single
    process returns False and touches nothing.

    The backend is `backend`, or NCCL when `device` (default "cuda") is a
    CUDA device and gloo otherwise. A CUDA rank's current device becomes
    `device` as named, or cuda:LOCAL_RANK for a bare "cuda". Must run before
    anything touches CUDA, so that every rank lands on its own card."""
    global _HOST_GROUP
    if dist.is_initialized():
        return True
    if not (bool(getattr(config, "distributed_init", False)) or _launched_world() > 1):
        return False
    missing = [v for v in _LAUNCH_VARS if not os.environ.get(v)]
    if missing:
        raise RuntimeError(f"a multi-process run needs the launcher's {', '.join(missing)}: "
                           "launch with torchrun, or unset distributed_init")
    device = torch.device(device if device is not None else "cuda")
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device.index if device.index is not None else int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    if backend != "gloo":
        _HOST_GROUP = dist.new_group(backend="gloo")
    LOGGER.info("torch.distributed initialized: rank %d/%d, backend %s, device %s",
                dist.get_rank(), dist.get_world_size(), backend,
                f"cuda:{torch.cuda.current_device()}" if device.type == "cuda" else device)
    from mafed_tpu_torch.core.preempt import reinstall_after_dist_init

    reinstall_after_dist_init()
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks. A launch of several ranks that has not joined its
    group raises rather than counting one."""
    if dist.is_initialized():
        return dist.get_world_size()
    if _launched_world() > 1:
        raise RuntimeError(f"WORLD_SIZE={_launched_world()} but no process group: "
                           "call maybe_initialize_distributed first")
    return 1


def is_main_process() -> bool:
    return process_index() == 0


def world_group() -> Group:
    return Group(tuple(range(process_count())), process_index())


def set_layout(data: Optional[Group], model: Optional[Group]) -> None:
    """Install the groups of a (data, model) mesh (core/mesh.make_mesh);
    None, None goes back to the 1-D layout."""
    global _LAYOUT
    _LAYOUT = None if data is None else (data, model)


def data_group() -> Group:
    """The ranks that hold this rank's shards: they split the rows of a
    global batch and average their gradients."""
    return _LAYOUT[0] if _LAYOUT is not None else world_group()


def model_group() -> Group:
    """The ranks that split the weights with this one and see its rows."""
    return _LAYOUT[1] if _LAYOUT is not None else Group((process_index(),), 0)


def data_index() -> int:
    return data_group().index


def data_size() -> int:
    return data_group().size


def model_index() -> int:
    return model_group().index


def model_size() -> int:
    return model_group().size


def barrier(name: str) -> None:
    """Wait until every rank reaches the barrier `name` (a no-op on one)."""
    if process_count() > 1:
        LOGGER.debug("barrier %s", name)
        dist.barrier()


def host_group():
    """The group of the collectives on host values: the default group under
    gloo, else the gloo group joined beside it. A CPU tensor reduced over
    NCCL would have to go through the card and wait for its queue."""
    if dist.get_backend() == "gloo":
        return None
    if _HOST_GROUP is None:
        raise RuntimeError("a process group joined without maybe_initialize_distributed has no host group")
    return _HOST_GROUP


def _size(group: Optional[Group]) -> int:
    return process_count() if group is None else group.size


def _torch_group(group: Optional[Group]):
    return None if group is None else group.group


def _host(group: Optional[Group]):
    """The gloo group of `group`'s host values."""
    if group is None or group.group is None:
        return host_group()
    return group.host


def process_reduce_sum(*values: float, group: Optional[Group] = None) -> Tuple[float, ...]:
    """Sum host scalars over the ranks of `group` (every rank by default)
    in float64 (the metric states of the reference's all_reduce,
    eval_utils.py:135-138); the values themselves on one rank."""
    if _size(group) == 1:
        return values
    t = torch.tensor(values, dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_host(group))
    return tuple(t.tolist())


def same_on_every_rank(obj: Any, group: Optional[Group] = None) -> bool:
    """Whether every rank of `group` (every rank by default) holds an equal
    `obj` (picklable)."""
    size = _size(group)
    if size == 1:
        return True
    gathered: List[Any] = [None] * size
    dist.all_gather_object(gathered, obj, group=_host(group))
    return all(g == gathered[0] for g in gathered)


def _coalesced(tensors: Iterable[torch.Tensor], collective: Callable[[torch.Tensor], None]) -> None:
    """Run `collective` on one flat buffer per (dtype, device) of `tensors`
    and copy the result back into them, in place."""
    groups: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            n = t.numel()
            t.copy_(flat[offset : offset + n].view_as(t))
            offset += n


def all_reduce_sum_(tensors: Iterable[torch.Tensor], group: Optional[Group] = None) -> None:
    """Sum `tensors` over the ranks of `group` (every rank by default) in
    place, one all-reduce per dtype."""
    if _size(group) > 1:
        _coalesced(tensors, lambda flat: dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=_torch_group(group)))


def all_reduce_mean_(tensors: Iterable[torch.Tensor], group: Optional[Group] = None) -> None:
    """Average `tensors` over the ranks of `group` (every rank by default)
    in place, one all-reduce per dtype: the sum, then a division by the
    number of ranks."""
    size = _size(group)
    if size > 1:
        def mean(flat: torch.Tensor) -> None:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=_torch_group(group))
            flat.div_(size)

        _coalesced(tensors, mean)


def broadcast_from_main_(tensors: Iterable[torch.Tensor], group: Optional[Group] = None) -> None:
    """Overwrite `tensors` on every rank of `group` (every rank by default)
    with those of its first rank, one broadcast per dtype."""
    if _size(group) > 1:
        src = 0 if group is None else group.ranks[0]
        _coalesced(tensors, lambda flat: dist.broadcast(flat, src=src, group=_torch_group(group)))


def broadcast_model_(model: torch.nn.Module) -> None:
    """Give every rank the parameters and buffers of `model` that the first
    rank of its data group holds: under tensor parallelism each shard goes
    to the ranks that hold the same shard."""
    group = data_group()
    if group.size > 1:
        with torch.no_grad():
            broadcast_from_main_([t for t in model.state_dict().values() if t.is_floating_point()], group)
