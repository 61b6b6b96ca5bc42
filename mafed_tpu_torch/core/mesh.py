"""The (data, model) rank grid and the tensor-parallel layout of VL-Pythia
(counterpart of mafed_tpu/core/mesh.py).

A run with mesh_shape [D, M] is D x M ranks, one device each (torchrun
--nproc_per_node D*M). Rank r = d * M + m: model peers are adjacent ranks,
the Megatron convention. Each model group of M ranks splits the decoder's
and the projector's weights (`param_partition_spec`); each data group of D
ranks (one per model index m) holds the same shards, splits the rows of a
global batch and averages its gradients. [D, 1] is core/dist.py's data
parallelism, where the data group is every rank.

The JAX package's mesh can hold several devices of one process; here a
rank drives one device, so D x M must equal the number of ranks. Its
`globalize_scalar_leaves` has no counterpart: orbax's refusal to save a
host-local array does not exist here, and the optimizer's counters are
host ints.

The layout is Megatron's (the JAX rule, on torch's [out, in] weights):

  * column-parallel: `attention.query_key_value`, `mlp.dense_h_to_4h` and
    the projector's first linear (`vision_embed_tokens.0`), weight and bias
    split over their outputs, dim 0. QKV is head-major ([heads, 3 *
    head_dim] rows, models/gpt_neox.py), so a contiguous split gives each
    rank whole heads with their q, k and v;
  * row-parallel: `attention.dense`, `mlp.dense_4h_to_h` and the
    projector's second linear (`vision_embed_tokens.2`), weight split over
    its inputs, dim 1; the bias is replicated and added once, after the
    partial products are summed;
  * vocab-parallel: `gpt_neox.embed_in` and `embed_out` split their vocabulary
    rows, dim 0;
  * everything else replicated: the layer norms and the frozen vision tower.

The JAX rule shards the EVA-02 / CLIP tower too, and its package gathers it
before every multi-process use (mafed_tpu/data/vision_cache.py:92-94); the
port keeps the tower replicated on every rank, which is what that gather
gives, and so primes the vision cache without a collective.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from mafed_tpu_torch.core import dist as D

_COLUMN = ("attention.query_key_value.", "mlp.dense_h_to_4h.", "vision_embed_tokens.0.")
_ROW = ("attention.dense.", "mlp.dense_4h_to_h.", "vision_embed_tokens.2.")
_VOCAB = ("gpt_neox.embed_in.weight", "embed_out.weight")


class Mesh(NamedTuple):
    shape: Tuple[int, int]  # (D, M)
    data: D.Group  # this rank's data group
    model: D.Group  # this rank's model group


def resolve_mesh_shape(mesh_shape: Optional[Sequence[int]], world: int) -> Tuple[int, int]:
    """(D, M) of `mesh_shape` over `world` ranks: a -1 absorbs the rest, a
    1-D shape has M = 1. Raises ValueError unless D x M == world."""
    dims = [int(x) for x in (mesh_shape or (-1, 1))]
    if len(dims) == 1:
        dims.append(1)
    if len(dims) != 2 or dims.count(-1) > 1 or any(x == 0 or x < -1 for x in dims):
        raise ValueError(f"mesh_shape {tuple(dims)}: expected [D, M], at most one of them -1")
    if -1 in dims:
        known = math.prod(x for x in dims if x != -1)
        dims[dims.index(-1)] = max(1, world // known)
    data, model = dims
    if data * model != world:
        raise ValueError(f"mesh_shape {tuple(mesh_shape or (-1, 1))} is a grid of {data} x {model} = "
                         f"{data * model} ranks, but the run has {world} rank(s): one device a rank")
    return data, model


def check_divides(model: int, model_cfg) -> None:
    """Raise ValueError unless a model axis of `model` splits the heads, the
    intermediate size, the hidden size (the projector's) and the vocabulary."""
    if model == 1:
        return
    for name in ("num_attention_heads", "intermediate_size", "hidden_size", "vocab_size"):
        if getattr(model_cfg, name) % model:
            raise ValueError(f"a model axis of {model} does not divide {name} = {getattr(model_cfg, name)}")


def _new_group(ranks: Tuple[int, ...]) -> D.Group:
    """A subgroup of `ranks` and its gloo twin for host values; every rank
    must call this for every group, in the same order."""
    group = dist.new_group(list(ranks))
    host = group if dist.get_backend() == "gloo" else dist.new_group(list(ranks), backend="gloo")
    rank = D.process_index()
    return D.Group(ranks, ranks.index(rank) if rank in ranks else -1, group, host)


def make_mesh(mesh_shape: Optional[Sequence[int]] = (-1, 1), world: Optional[int] = None) -> Mesh:
    """The (data, model) grid over the ranks of the run, installed as the
    layout of core/dist.py. Every rank creates every model group, then
    every data group, in the same order; a group that spans every rank is
    the default group, and one of a single rank creates nothing. A model
    axis of 1 is the 1-D layout of core/dist.py, which installs nothing.
    Once a grid is installed, a call with its shape returns it and another
    shape raises ValueError: a process runs one layout."""
    world = D.process_count() if world is None else world
    data, model = resolve_mesh_shape(mesh_shape, world)
    if D._LAYOUT is not None:
        installed = (D._LAYOUT[0].size, D._LAYOUT[1].size)
        if installed != (data, model):
            raise ValueError(f"mesh_shape {tuple(mesh_shape or (-1, 1))} asks for a {data} x {model} grid, but this "
                             f"process runs a {installed[0]} x {installed[1]} one")
        return Mesh((data, model), *D._LAYOUT)
    if model == 1:  # the 1-D layout: every rank is the data group
        return Mesh((data, 1), D.data_group(), D.model_group())
    rank = D.process_index()

    def group(ranks: Tuple[int, ...]) -> D.Group:
        if len(ranks) == world:
            return D.world_group()
        if len(ranks) == 1:
            return D.Group(ranks, 0)
        return _new_group(ranks)

    model_groups = [group(tuple(range(d * model, (d + 1) * model))) for d in range(data)]
    data_groups = [group(tuple(range(m, world, model))) for m in range(model)]
    mesh = Mesh((data, model), data_groups[rank % model], model_groups[rank // model])
    D.set_layout(mesh.data, mesh.model)
    return mesh


def param_partition_spec(name: str) -> Optional[int]:
    """The dim of the state_dict entry `name` (torch names, [out, in]
    weights) split over the model axis, or None where it is replicated. A
    name may carry a prefix: the optimizer state's ("adam.mu.<name>", ...)
    split like its parameter."""
    if "vision_encoder." in name:
        return None
    if name.endswith(_VOCAB):
        return 0
    if any(k in name for k in _COLUMN):
        return 0
    if any(k in name for k in _ROW):
        return 1 if name.endswith(".weight") else None
    return None


def shard_tensor(t: torch.Tensor, dim: int, group: D.Group) -> torch.Tensor:
    """This rank's contiguous slice of `t` along `dim` (a view)."""
    if t.shape[dim] % group.size:
        raise ValueError(f"a model axis of {group.size} does not divide dim {dim} of shape {tuple(t.shape)}")
    n = t.shape[dim] // group.size
    return t.narrow(dim, group.index * n, n)


def shard_state_dict(state_dict, group: Optional[D.Group]):
    """This rank's shard of a full state_dict (views of its tensors); the
    state_dict itself without a model axis."""
    if group is None or group.size == 1:
        return state_dict
    out = {}
    for k, v in state_dict.items():
        dim = param_partition_spec(k)
        out[k] = v if dim is None else shard_tensor(v, dim, group)
    return out


def gather_tensor(t: torch.Tensor, dim: int, group: D.Group) -> torch.Tensor:
    """The full tensor of which every rank of `group` holds its slice `t`
    along `dim` (collective)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group.size)]
    dist.all_gather(parts, t, group=group.group)
    return torch.cat(parts, dim=dim)


def gather_state_dict(state_dict, group: Optional[D.Group]):
    """The full state_dict of which every rank of `group` holds its shard
    (collective: every rank of the group calls it, with the same keys in
    the same order); the state_dict itself without a model axis."""
    if group is None or group.size == 1:
        return state_dict
    out = {}
    for k, v in state_dict.items():
        dim = param_partition_spec(k)
        out[k] = v if dim is None else gather_tensor(v, dim, group)
    return out
