"""Megatron's layers over a model group (core/mesh.py), as plain autograd
functions on `dist.all_reduce`:

  * `copy_to_model_group`: the identity forward and an all-reduce of the
    gradient, before every column-parallel product (its input is
    replicated, and each rank's product feeds its own share of the
    gradient);
  * `reduce_from_model_group`: an all-reduce forward of the partial
    products and the identity backward, after every row-parallel product;
  * `vocab_parallel_embedding`: each rank looks up the ids of its rows of
    the vocabulary, zeroes the others, and the rows are summed;
  * `vocab_parallel_cross_entropy`: the softmax CE over logits whose
    vocabulary is split: the max and the sum of exponentials all-reduced,
    the target logit taken from its owner's shard.

`shard_model_` turns a VLPythia into this rank's shard: the split
parameters narrowed to its slice, and `tp` (the model group) set on the
modules whose forward runs these collectives. Every rank of the group
enters every forward and backward together, in the same order. Sums over
ranks reorder the sums of one process: the results agree with it to
rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from mafed_tpu_torch.core.dist import Group
from mafed_tpu_torch.core.mesh import param_partition_spec, shard_tensor


def _active(group: Optional[Group]) -> bool:
    return group is not None and group.size > 1


class _CopyToModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group.group)
        return grad, None


class _ReduceFromModelGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model_group(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    return _CopyToModelGroup.apply(x, group) if _active(group) else x


def reduce_from_model_group(x: torch.Tensor, group: Optional[Group]) -> torch.Tensor:
    return _ReduceFromModelGroup.apply(x, group) if _active(group) else x


def vocab_parallel_embedding(ids: torch.Tensor, weight: torch.Tensor, group: Group) -> torch.Tensor:
    """Rows of the embedding table whose vocabulary is split over `group`
    (this rank holds rows index * n .. (index + 1) * n - 1): exactly the
    rows of the whole table, in its dtype."""
    rows = weight.shape[0]
    local = ids.long() - group.index * rows
    outside = (local < 0) | (local >= rows)
    out = F.embedding(local.masked_fill(outside, 0), weight)
    return reduce_from_model_group(out.masked_fill(outside[..., None], 0.0), group)


class _VocabParallelCE(torch.autograd.Function):
    """-log softmax(logits)[target] in float32, the vocabulary split over
    the group (the forward of F.log_softmax(logits.float()) and a gather)."""

    @staticmethod
    def forward(ctx, logits, target, group):
        x = logits.float()
        vmax = x.max(dim=-1).values
        dist.all_reduce(vmax, op=dist.ReduceOp.MAX, group=group.group)
        x = x - vmax[..., None]
        rows = x.shape[-1]
        local = target.long() - group.index * rows
        mine = (local >= 0) & (local < rows)
        local = local.clamp(0, rows - 1)
        picked = torch.where(mine, torch.gather(x, -1, local[..., None])[..., 0], 0.0)
        exp = x.exp_()
        sums = torch.stack([picked, exp.sum(dim=-1)])
        dist.all_reduce(sums, group=group.group)
        picked, sumexp = sums[0], sums[1]
        ctx.save_for_backward(exp.div_(sumexp[..., None]), local, mine)
        ctx.dtype = logits.dtype
        return torch.log(sumexp) - picked

    @staticmethod
    def backward(ctx, grad):
        softmax, local, mine = ctx.saved_tensors
        g = softmax.clone()
        g.scatter_add_(-1, local[..., None], -mine.to(g.dtype)[..., None])
        return (g * grad[..., None]).to(ctx.dtype), None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, target: torch.Tensor, group: Group) -> torch.Tensor:
    """Per-position CE [...] of logits [..., V / M] against target ids [...]."""
    return _VocabParallelCE.apply(logits, target, group)


@torch.no_grad()
def shard_model_(model, group: Optional[Group]):
    """Narrow `model`'s (a VLPythia) split parameters to this rank's slice
    of `group`, in place, and set `tp` on the modules that run the
    collectives; returns the model. Nothing changes without a model axis."""
    if not _active(group):
        return model
    for name, p in model.named_parameters():
        dim = param_partition_spec(name)
        if dim is not None:
            p.data = shard_tensor(p.data, dim, group).clone()
    model.tp = model.gpt_neox.tp = group
    for layer in model.gpt_neox.layers:
        layer.tp = group
    return model
