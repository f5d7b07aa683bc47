"""Run a plain op on the local shards of DTensor inputs.

The attention, SSD and RG-LRU ops (and the plain attention of decode and of
the encoder-decoder's cross-attention) are written for whole tensors.  When
their inputs are DTensors, :func:`per_shard` runs them per shard under
``torch.distributed.tensor.experimental.local_map``, the counterpart of how
GSPMD partitions the reference's plain attention: every mesh dim that
shards the anchor input's batch dim keeps the batch there, every other mesh
dim takes the op's heads (or channels) where they divide and is replicated
where they do not.  The inputs are redistributed to that layout first.  So
the plain code never sees a DTensor, and no op inside it has to propagate a
sharding (the heads' reshape of a sharded projection would give DTensor's
batched matmuls a strided shard it cannot propagate).

Each input and output is described by its roles, one a dim: ``"batch"``,
``"heads"`` or ``None`` (whole on every rank).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = ["is_dtensor", "per_shard", "shard_layout", "split_dim"]

Roles = Tuple[Optional[str], ...]


def is_dtensor(x) -> bool:
    """True for a DTensor (checked without importing DTensor into plain runs)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def split_dim(x, dim: int, parts: int):
    """``x``, about to have its dim ``dim`` split into ``parts`` x rest: a
    DTensor keeps that dim sharded over a mesh dim only while the product
    of those mesh dims divides ``parts`` (else the split's shards would be
    uneven), and is replicated over the others; a plain tensor comes back as
    it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    dim %= x.dim()
    out, n = [], 1
    for i, pl in enumerate(x.placements):
        if pl.is_shard(dim):
            if parts % (n * x.device_mesh.size(i)) == 0:
                n *= x.device_mesh.size(i)
            else:
                pl = Replicate()
        out.append(pl)
    return x.redistribute(x.device_mesh, out)


def shard_layout(anchor, anchor_roles: Roles, heads: Sequence[int]):
    """The role each mesh dim carries: ``"batch"`` where ``anchor`` shards
    its batch dim, else ``"heads"`` where every size in ``heads`` divides by
    the product of the mesh dims that shard heads, else None."""
    mesh = anchor.device_mesh
    batch_dim = anchor_roles.index("batch") if "batch" in anchor_roles else None
    out, n_heads = [], 1
    for i, pl in enumerate(anchor.placements):
        if batch_dim is not None and pl.is_shard(batch_dim):
            out.append("batch")
        elif heads and all(h % (n_heads * mesh.size(i)) == 0 for h in heads):
            n_heads *= mesh.size(i)
            out.append("heads")
        else:
            out.append(None)
    return mesh, out


def _placements(layout, roles: Optional[Roles], partial_over: Sequence[str] = ()):
    from torch.distributed.tensor import Partial, Replicate, Shard

    if roles is None:
        return None
    out = []
    for role in layout:
        if role is not None and role in roles:
            out.append(Shard(roles.index(role)))
        elif role is not None and role in partial_over:
            out.append(Partial())
        else:
            out.append(Replicate())
    return out                  # a list: local_map reads a tuple as one per output


def per_shard(fn: Callable, args: Sequence, in_roles: Sequence[Optional[Roles]],
              out_roles, *, heads: Sequence[int], anchor: int = 0,
              partial_over: Sequence[Sequence[str]] = ()):
    """``fn(*args)`` on each rank's shards of the DTensors in ``args``.

    ``in_roles[i]`` gives the roles of ``args[i]`` (None for a non-tensor
    or an absent optional tensor), ``out_roles`` those of ``fn``'s output(s)
    (a tuple of roles for one output, a list of them for several).
    ``heads`` are the sizes that the mesh dims which do not carry the batch
    must divide to shard the heads role.  An output whose entry of
    ``partial_over`` names a role is left as a partial sum over the mesh dims
    of that role (its shards are summands, as a row-parallel matmul's).
    Plain tensors among ``args`` are taken as replicated.  The gradient of
    an input that is whole on a mesh dim carrying the batch or the heads is
    a partial sum there (each rank's share).
    """
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(args[anchor], DTensor):
        anchor = next(i for i, a in enumerate(args)
                      if isinstance(a, DTensor) and in_roles[i] is not None)
    mesh, layout = shard_layout(args[anchor], in_roles[anchor], heads)
    args = [DTensor.from_local(a, mesh, _placements(layout, (None,) * a.dim()),
                               run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) else a
            for a in args]
    in_pl = tuple(_placements(layout, r) for r in in_roles)
    # An input whole on a mesh dim that splits the work (the batch or the
    # heads) gets a share of its gradient from each rank there: a partial sum.
    grad_pl = tuple(_placements(layout, r, partial_over=("batch", "heads"))
                    for r in in_roles)
    many = isinstance(out_roles, list)
    outs = out_roles if many else [out_roles]
    parts = list(partial_over) + [()] * (len(outs) - len(partial_over))
    out_pl = [_placements(layout, r, p) for r, p in zip(outs, parts)]
    return local_map(fn, out_placements=tuple(out_pl) if many else out_pl[0],
                     in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)

