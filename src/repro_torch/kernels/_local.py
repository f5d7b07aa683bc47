"""Run a plain op on the local shards of DTensor inputs.

The attention, SSD and RG-LRU ops (and the plain attention of decode and of
the encoder-decoder's cross-attention) are written for whole tensors.  When
their inputs are DTensors, :func:`per_shard` runs them per shard under
``torch.distributed.tensor.experimental.local_map``, the counterpart of how
GSPMD partitions the reference's plain attention: every mesh dim that
shards the anchor input's batch dim keeps the batch there; a mesh dim that
shards the anchor's query rows (the reference's ``attn_shard_mode="seq"``)
keeps them there; every other mesh dim takes the op's heads (or channels)
where they divide, else the query rows where the op has them (more than one
row, and they divide), and is replicated where it can take neither.  The
inputs are redistributed to that layout first.  So
the plain code never sees a DTensor, and no op inside it has to propagate a
sharding (the heads' reshape of a sharded projection would give DTensor's
batched matmuls a strided shard it cannot propagate).

Each input and output is described by its roles, one a dim: ``"batch"``,
``"heads"``, ``"rows"`` (a split of the query sequence: the keys and values
stay whole on those mesh dims, and each rank's rows start at
:func:`row_offset`), ``"inner"`` (a dim the op contracts: its outputs are
partial sums there) or ``None`` (whole on every rank).  With ``heads=None``
the op runs in the anchor's own layout (a decode state's: each mesh dim
takes the role of the dim it shards), so that the state never moves.

:func:`regroup` splits a tensor sharded on its last dim into pieces that
are each sharded evenly, with one all-to-all of the elements that change
rank (a projection whose outputs do not fall on its shards' bounds), and
:func:`repeat_heads` gives each rank the K/V heads of its q heads the same
way.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = ["block_index", "is_dtensor", "last_row", "move_split", "one_row",
           "per_shard", "regroup", "repeat_heads", "row_offset", "rows_split",
           "shard_layout", "split_dim"]

Roles = Tuple[Optional[str], ...]


def is_dtensor(x) -> bool:
    """True for a DTensor (checked without importing DTensor into plain runs)."""
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def split_dim(x, dim: int, parts: int):
    """``x``, about to have its dim ``dim`` split into ``parts`` x rest (or
    just merged from them: its gradient comes back in the layout returned,
    and the merge's backward splits that): a
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


def one_row(x) -> bool:
    """One token a row: ``x`` is (B, 1, ...), a decode step's tokens or
    activations.  The layouts that differ there (the FSDP shards kept,
    ``models/common.py::on_use``, and the stream split on d_model,
    ``train/sharding.py::ActivationSharding.hidden``) both ask this."""
    return x.dim() >= 2 and x.shape[1] == 1


def rows_split(x) -> Tuple[int, ...]:
    """The mesh dims that split the sequence (dim 1, more than one row) of
    the DTensor ``x`` (a sequence-parallel activation); () for others."""
    if not is_dtensor(x) or x.dim() < 3 or x.shape[1] <= 1:
        return ()
    return tuple(i for i, pl in enumerate(x.placements) if pl.is_shard(1))


def block_index(mesh, dims: Sequence[int]) -> Tuple[int, int]:
    """This rank's block of a tensor dim split over the mesh dims ``dims``,
    in mesh order (as DTensor splits a dim over several mesh dims), and the
    number of blocks.  The coordinate comes from
    ``DeviceMesh.get_local_rank``: 0 on the dry-run's rank 0."""
    index, n = 0, 1
    for i in dims:
        index, n = index * mesh.size(i) + mesh.get_local_rank(i), n * mesh.size(i)
    return index, n


def move_split(x, src, dst: int, dims: Optional[Sequence[int]] = None, *,
               whole_rest: bool = False):
    """``x`` with its split on dim ``src`` (or, for ``src="partial"``, its
    partial sums) moved to dim ``dst`` on the mesh dims ``dims`` (default:
    every mesh dim that holds it), in mesh order while ``dst`` divides and
    no other mesh dim splits ``dst``: an all-to-all each (a reduce-scatter
    for a partial sum).  Those where it does not are made whole where
    ``whole_rest``, else left as they are.  A plain tensor as it is."""
    if not is_dtensor(x) or (dims is not None and not dims):
        return x
    from torch.distributed.tensor import Replicate, Shard

    holds = ((lambda pl: pl.is_partial()) if src == "partial"
             else (lambda pl: pl.is_shard(src % x.dim())))
    mesh, dst, n = x.device_mesh, dst % x.dim(), 1
    free = not any(pl.is_shard(dst) for pl in x.placements)
    out = list(x.placements)
    for i, pl in enumerate(x.placements):
        if not holds(pl) or (dims is not None and i not in dims):
            continue
        if free and x.shape[dst] % (n * mesh.size(i)) == 0:
            n *= mesh.size(i)
            out[i] = Shard(dst)
        elif whole_rest:
            out[i] = Replicate()
    return x.redistribute(mesh, out)


def last_row(x):
    """``x[:, -1:]``.  For a DTensor split on its sequence, the rank that
    holds the last row gives it and the others zeros, summed over the mesh
    dims that split the rows (slicing the split dim would gather it)."""
    dims = rows_split(x)
    if not dims:
        return x[:, -1:]
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    holds = all(mesh.get_local_rank(i) == mesh.size(i) - 1 for i in dims)
    pl = list(x.placements)
    out = local_map(lambda t: t[:, -1:] if holds else torch.zeros_like(t[:, -1:]),
                    out_placements=[Partial() if i in dims else p for i, p in enumerate(pl)],
                    in_placements=(pl,), device_mesh=mesh)(x)
    return out.redistribute(mesh, [Replicate() if i in dims else p for i, p in enumerate(pl)])


def regroup(x, sizes: Sequence[int]):
    """``torch.split(x, sizes, dim=-1)``, each piece sharded evenly on its
    last dim over the mesh dim that shards x's (x a DTensor whose last dim
    one mesh dim shards, and whose sizes all divide by that dim's size).
    Each rank sends the elements of its shard that another rank's pieces
    hold in one all-to-all (its gradient the reverse one).  Otherwise x is
    gathered on its last dim (:func:`split_dim`) and split; a plain tensor
    is just split."""
    if not is_dtensor(x):
        return torch.split(x, sizes, dim=-1)
    last = x.dim() - 1
    dims = [i for i, pl in enumerate(x.placements) if pl.is_shard(last)]
    n = x.device_mesh.size(dims[0]) if len(dims) == 1 else 0
    if not n or any(s % n for s in sizes):
        return torch.split(split_dim(x, -1, 1), sizes, dim=-1)
    from torch.distributed.tensor import DTensor

    mesh, m = x.device_mesh, dims[0]
    rank, chunk = mesh.get_local_rank(m), x.shape[-1] // n
    starts = [sum(sizes[:j]) for j in range(len(sizes))]

    def span(q, j, r):
        """Global [lo, hi) of piece j that rank q holds after and rank r before."""
        c = sizes[j] // n
        return (max(starts[j] + q * c, r * chunk),
                min(starts[j] + (q + 1) * c, (r + 1) * chunk))

    send, in_splits = [], []
    for q in range(n):
        parts = [range(lo - rank * chunk, hi - rank * chunk)
                 for lo, hi in (span(q, j, rank) for j in range(len(sizes))) if lo < hi]
        send += [i for p in parts for i in p]
        in_splits.append(sum(map(len, parts)))
    # The received elements come by source rank; each piece gathers its own.
    seg, out_splits, at = {}, [], 0
    for r in range(n):
        for j in range(len(sizes)):
            lo, hi = span(rank, j, r)
            if lo < hi:
                seg[j, r] = range(at, at + hi - lo)
                at += hi - lo
        out_splits.append(at - sum(out_splits))
    order = [i for j in range(len(sizes)) for r in range(n) for i in seg.get((j, r), ())]
    got = _exchange(x, m, send, in_splits, out_splits, order)
    out = []
    for piece, size in zip(torch.split(got, [s // n for s in sizes], dim=-1), sizes):
        shape = torch.Size(tuple(x.shape[:-1]) + (size,))
        out.append(DTensor.from_local(piece.contiguous(), mesh, x.placements,
                                      run_check=False,
                                      shape=shape,
                                      stride=torch.empty(shape, device="meta").stride()))
    return out


def _exchange(x, m: int, send, in_splits, out_splits, order):
    """The elements ``send`` of the last dim of the DTensor ``x``'s local
    piece, sent ``in_splits`` to each rank of mesh dim ``m`` in one
    all-to-all (its gradient the reverse one), the ``out_splits`` received
    put in ``order``: a local tensor."""
    import torch.distributed._functional_collectives as funcol

    local = x.to_local()
    idx = lambda i: torch.tensor(i, device=local.device, dtype=torch.long)  # noqa: E731
    local = local.index_select(-1, idx(send))
    a2a = (funcol.all_to_all_single_autograd if local.requires_grad
           else funcol.all_to_all_single)
    got = a2a(local.movedim(-1, 0).contiguous(), out_splits, in_splits,
              (x.device_mesh, m))
    return got.movedim(0, -1).index_select(-1, idx(order))


def repeat_heads(y, n_heads: int, reps: int):
    """``y`` (..., n_heads * dh) as (..., n_heads * reps, dh), each head
    repeated ``reps`` times in place (``repeat_interleave``: GQA's K/V for
    the q heads), for a DTensor ``y`` split on its last dim over one mesh
    dim whose size divides the repeated heads but not ``n_heads`` (a K/V
    projection whose heads the mesh dim does not divide, where the q heads
    it does): the result is split on its heads there, and each rank
    receives the columns of its heads' sources from the ranks that hold
    them in one all-to-all (a few ranks each, where a gather would take
    every rank's), its gradient the reverse one, summed where a column went
    to several heads.  None where ``y`` is not so split."""
    if not is_dtensor(y) or any(pl.is_partial() for pl in y.placements):
        return None
    last = y.dim() - 1
    dims = [i for i, pl in enumerate(y.placements) if pl.is_shard(last)]
    if len(dims) != 1:
        return None
    mesh, m = y.device_mesh, dims[0]
    n, heads, dh = mesh.size(m), n_heads * reps, y.shape[-1] // n_heads
    if heads % n or n_heads % n == 0 or y.shape[-1] % n:
        return None
    from torch.distributed.tensor import DTensor, Shard

    rank, chunk, per = mesh.get_local_rank(m), y.shape[-1] // n, heads // n

    def need(r):
        """The columns rank r's heads take, in their order."""
        return [(h // reps) * dh + i for h in range(r * per, (r + 1) * per)
                for i in range(dh)]

    send, in_splits = [], []
    for r in range(n):
        cols = sorted(c - rank * chunk for c in set(need(r)) if c // chunk == rank)
        send += cols
        in_splits.append(len(cols))
    got = sorted(set(need(rank)), key=lambda c: (c // chunk, c))
    out_splits = [sum(1 for c in got if c // chunk == q) for q in range(n)]
    where = {c: i for i, c in enumerate(got)}
    out = _exchange(y, m, send, in_splits, out_splits, [where[c] for c in need(rank)])
    out = out.reshape(*out.shape[:-1], per, dh)
    shape = torch.Size(tuple(y.shape[:-1]) + (heads, dh))
    return DTensor.from_local(out.contiguous(), mesh,
                              [Shard(last) if i == m else pl
                               for i, pl in enumerate(y.placements)],
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def shard_layout(anchor, anchor_roles: Roles, heads: Sequence[int], *,
                 check_rows: bool = True):
    """The role each mesh dim carries, in mesh order: ``"batch"`` where
    ``anchor`` shards its batch dim; ``"rows"`` where it shards its rows dim
    (q sharded on its sequence, as the reference's ``attn_shard_mode="seq"``
    constrains it); else ``"heads"`` where every size in ``heads`` divides
    by the product of the mesh dims that shard heads; else ``"rows"`` where
    the anchor has a rows dim of more than one row (heads that do not divide
    the mesh dim: GSPMD pads them, and a split of the query rows does the
    same work at exactly 1/n); else None.  Raises where the rows are to be
    split but do not divide by the product of the mesh dims that split
    them, unless ``check_rows`` is false (a probe that reads only where the
    heads go)."""
    mesh = anchor.device_mesh
    batch_dim = anchor_roles.index("batch") if "batch" in anchor_roles else None
    rows_dim = anchor_roles.index("rows") if "rows" in anchor_roles else None
    rows = anchor.shape[rows_dim] if rows_dim is not None else 0
    out, n_heads, n_rows = [], 1, 1
    for i, pl in enumerate(anchor.placements):
        size = mesh.size(i)
        if batch_dim is not None and pl.is_shard(batch_dim):
            out.append("batch")
            continue
        if not (rows_dim is not None and pl.is_shard(rows_dim)):
            if heads and all(h % (n_heads * size) == 0 for h in heads):
                n_heads *= size
                out.append("heads")
                continue
            if rows <= 1:
                out.append(None)
                continue
        if check_rows and rows % (n_rows * size):
            raise ValueError(
                f"{rows} query rows do not split over {n_rows * size} ranks "
                f"(mesh dim {i}), and the heads {tuple(heads)} do not divide it")
        n_rows *= size
        out.append("rows")
    return mesh, out


def row_offset(mesh, layout, local_rows: int) -> int:
    """The index of this rank's first query row: its block of rows over the
    mesh dims of ``layout`` that carry ``"rows"``, in mesh order (as DTensor
    splits a dim over several mesh dims, :func:`block_index`), times
    ``local_rows``."""
    index, _ = block_index(mesh, [i for i, role in enumerate(layout) if role == "rows"])
    return index * local_rows


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
              out_roles, *, heads: Optional[Sequence[int]], anchor: int = 0,
              partial_over: Sequence[Sequence[str]] = ()):
    """``fn(*args)`` on each rank's shards of the DTensors in ``args``.

    ``in_roles[i]`` gives the roles of ``args[i]`` (None for a non-tensor
    or an absent optional tensor), ``out_roles`` those of ``fn``'s output(s)
    (a tuple of roles for one output, a list of them for several).
    ``heads`` are the sizes that the mesh dims which do not carry the batch
    must divide to shard the heads role; ``heads=None`` runs in the anchor's
    own layout (each mesh dim carries the role of the anchor dim it shards,
    none where the anchor is whole).  An output whose entry of
    ``partial_over`` names a role is left as a partial sum over the mesh dims
    of that role (its shards are summands, as a row-parallel matmul's).
    Plain tensors among ``args`` are taken as replicated.  The gradient of
    an input that is whole on a mesh dim carrying the batch, the heads or
    the rows is a partial sum there (each rank's share: the keys and values
    of a rows split take a gradient from every rank's rows).
    """
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(args[anchor], DTensor):
        anchor = next(i for i, a in enumerate(args)
                      if isinstance(a, DTensor) and in_roles[i] is not None)
    if heads is None:
        mesh = args[anchor].device_mesh
        layout = [in_roles[anchor][pl.dim] if pl.is_shard() else None
                  for pl in args[anchor].placements]
    else:
        mesh, layout = shard_layout(args[anchor], in_roles[anchor], heads)
    args = [DTensor.from_local(a, mesh, _placements(layout, (None,) * a.dim()),
                               run_check=False)
            if isinstance(a, torch.Tensor) and not isinstance(a, DTensor) else a
            for a in args]
    in_pl = tuple(_placements(layout, r) for r in in_roles)
    # An input whole on a mesh dim that splits the work (the batch, the
    # heads, the rows or a contracted dim) gets a share of its gradient from
    # each rank there: a partial sum.
    grad_pl = tuple(_placements(layout, r, partial_over=("batch", "heads", "rows", "inner"))
                    for r in in_roles)
    many = isinstance(out_roles, list)
    outs = out_roles if many else [out_roles]
    parts = list(partial_over) + [()] * (len(outs) - len(partial_over))
    out_pl = [_placements(layout, r, p) for r, p in zip(outs, parts)]

    def local(*xs):
        return fn(*[_ContiguousGrad.apply(x) if isinstance(x, torch.Tensor)
                    and x.requires_grad else x for x in xs])

    return local_map(local, out_placements=tuple(out_pl) if many else out_pl[0],
                     in_placements=in_pl, in_grad_placements=grad_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient comes back contiguous.  ``local_map``
    wraps an input's local gradient as a DTensor as it comes; a transposed
    one (attention's key gradient with one head a rank, seamless-m4t-medium
    on a 16-rank model axis) fails the view that the projection's backward
    then runs on it, which DTensor's sharding propagation allows."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()

