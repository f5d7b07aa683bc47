"""Dispatch-trace analysis: collective inventory, per-device cost and roofline
terms; port of ``repro.launch.hlo_analysis``.

There is no HLO here.  The dry-run (``launch/dryrun.py``) runs one step on
DTensors whose local shards are ``meta`` tensors, and two
``TorchDispatchMode``s read the ops each rank would run:

- :class:`CollectiveCounter` records each collective by kind, result bytes
  and group size, and sums the bytes it moves per device with the
  reference's wire formulas:

      all-gather:          result_bytes * (n-1)/n      (data received)
      all-reduce:          2 * in_bytes * (n-1)/n      (ring: RS + AG phases)
      reduce-scatter:      in_bytes * (n-1)/n
      all-to-all:          result_bytes * (n-1)/n
      collective-permute:  result_bytes

  where n is the group's size.  It records the collective the layout calls
  for: DTensor moves a Shard(i) -> Shard(j) redistribute with one all-to-all
  on a ``cuda`` mesh but with an all-gather and a chunk on a ``cpu`` one
  (gloo has no all-to-all), and both count as one all-to-all.
- :class:`CostCounter` sums the per-device cost of the local ops: FLOPs of
  the matmul-class ops that ``torch.utils.flop_counter`` knows (mm, bmm,
  addmm, baddbmm, convolutions, attention), where XLA's ``cost_analysis``
  also counts elementwise ops and transcendentals; bytes, each op's inputs
  read once and outputs written once (an unfused upper bound, as the
  reference's CPU HLO bytes are); and the peak of the storages alive at
  once, split as XLA's memory analysis splits it.

Both see only the ops each rank runs on its shards: an op on DTensors is
left to DTensor (which runs the local ops, seen next), and the ops DTensor
runs to propagate a sharding (on fake tensors of the global shape, or a
decomposition on a one-rank mesh) are not counted: counting them would add
a global op to each local one.  An op made of others (``aten.matmul``) is
counted as the ops it decomposes into.

Hardware model: an H100 SXM5 80GB (chip_smoke.py reports it as "NVIDIA H100
80GB HBM3, 700.00 W"); see :class:`HW`.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["HW", "CARD", "CollectiveStats", "CollectiveCounter", "CostCounter",
           "wire_bytes", "roofline_terms"]

CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


@dataclass(frozen=True)
class HW:
    """One H100 SXM5 80GB (``CARD``)."""
    # Dense bf16 tensor-core FLOP/s per GPU (NVIDIA H100 datasheet, SXM5;
    # 1979 TFLOP/s with 2:4 sparsity).
    peak_flops: float = 989.4e12
    # HBM3 bytes/s per GPU (NVIDIA H100 datasheet, SXM5 80GB).
    hbm_bw: float = 3.35e12
    # Bytes/s a GPU moves for a collective over a 16-wide mesh axis: 16
    # ranks span two 8-GPU NVLink nodes, so a ring over the axis crosses
    # the nodes' InfiniBand, one 400 Gb/s NDR NIC a GPU (50e9 B/s each way);
    # NVLink 4 (450e9 B/s each way) is not the ring's slowest link.
    link_bw: float = 50e9


def wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Bytes one device moves for a collective of ``kind`` whose result is
    ``result_bytes`` on a group of ``n`` (the reference's formulas)."""
    frac = (n - 1) / max(n, 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * frac
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)       # input = result * n
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * frac
    return float(result_bytes)              # collective-permute


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    total_wire_bytes: float = 0.0       # per-device bytes on the wire

    def add(self, kind: str, result_bytes: float, n: int) -> None:
        wire = wire_bytes(kind, result_bytes, n)
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) + wire
        self.total_wire_bytes += wire

    def to_json(self) -> dict:
        return {"counts": self.counts, "bytes_by_kind": self.bytes_by_kind,
                "total_wire_bytes": self.total_wire_bytes}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors of an op's arguments or outputs: tensors, and tensors in
    (nested) lists, tuples and dicts."""
    out: List[torch.Tensor] = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


class _Propagation:
    """Marks the calls of DTensor's sharding propagation while a counter is
    active (``ShardingPropagator.propagate_op_sharding_non_cached`` wrapped;
    nested counters share one wrapper)."""
    depth = 0
    users = 0
    original = None

    @classmethod
    def enter(cls) -> None:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        cls.users += 1
        if cls.users > 1:
            return
        cls.original = original = ShardingPropagator.propagate_op_sharding_non_cached

        def propagate(self, *args, **kwargs):
            cls.depth += 1
            try:
                return original(self, *args, **kwargs)
            finally:
                cls.depth -= 1

        ShardingPropagator.propagate_op_sharding_non_cached = propagate

    @classmethod
    def exit(cls) -> None:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        cls.users -= 1
        if cls.users == 0:
            ShardingPropagator.propagate_op_sharding_non_cached = cls.original


def _on_dtensors(types) -> bool:
    """An op on DTensors: the modes leave it to DTensor, which runs the
    local ops (seen next)."""
    from torch.distributed.tensor import DTensor
    return any(t is DTensor or issubclass(t, DTensor) for t in types)


def _global(*trees) -> bool:
    """An op of DTensor's sharding propagation: inside it, or on or to fake
    tensors (its global-shape tensor metadata)."""
    from torch._subclasses.fake_tensor import FakeTensor
    return _Propagation.depth > 0 or any(isinstance(t, FakeTensor)
                                         for t in _tensors(trees))


_COMPOSITE: Dict = {}


def _composite(func) -> bool:
    """An op made of other ops (``aten.matmul``, ``aten.einsum``, ...).  Such
    an op reaches the modes whole under ``torch.inference_mode`` (prefill and
    decode), where autograd does not decompose it first."""
    known = _COMPOSITE.get(func)
    if known is None:
        known = _COMPOSITE[func] = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), "CompositeImplicitAutograd")
    return known


def _group_size(group) -> int:
    """The size of a functional collective's group (by name) or of a c10d
    op's process group (a script object)."""
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(group).size()
    return torch.distributed.ProcessGroup.unbox(group).size()


def _collective_table():
    """op -> (kind, where its result is, where its group is)."""
    ops, table = torch.ops, {}

    def add(namespace, name, kind, result, group):
        op = getattr(getattr(ops, namespace), name, None)
        if op is not None:
            table[op.default] = (kind, result, group)

    add("_c10d_functional", "all_reduce", "all-reduce", "out", 2)
    add("_c10d_functional", "all_gather_into_tensor", "all-gather", "out", 2)
    add("_c10d_functional", "reduce_scatter_tensor", "reduce-scatter", "out", 3)
    add("_c10d_functional", "all_to_all_single", "all-to-all", "out", 3)
    add("_c10d_functional_autograd", "all_to_all_single", "all-to-all", "out", 3)
    add("_dtensor", "shard_dim_alltoall", "all-to-all", "out", 3)
    add("c10d", "allreduce_", "all-reduce", 0, 1)
    add("c10d", "_allgather_base_", "all-gather", 0, 2)
    add("c10d", "allgather_", "all-gather", 0, 2)
    add("c10d", "_reduce_scatter_base_", "reduce-scatter", 0, 2)
    add("c10d", "reduce_scatter_", "reduce-scatter", 0, 2)
    add("c10d", "alltoall_base_", "all-to-all", 0, 2)
    add("c10d", "alltoall_", "all-to-all", 0, 2)
    return table


class CollectiveCounter(TorchDispatchMode):
    """Records every collective the local ops run (see the module
    docstring) into ``self.stats``."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()
        self._table = _collective_table()
        self._inside = 0          # > 0 inside a Shard -> Shard all-to-all
        self._patched: List = []

    def __enter__(self):
        import torch.distributed.tensor._collective_utils as cu
        import torch.distributed.tensor.placement_types as pt

        original = getattr(cu, "shard_dim_alltoall", None)
        if original is not None:
            def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
                self._inside += 1
                try:
                    out = original(input, gather_dim, shard_dim, mesh, mesh_dim)
                finally:
                    self._inside -= 1
                self.stats.add("all-to-all", _nbytes(out), mesh.size(mesh_dim))
                return out

            for module in (cu, pt):
                if getattr(module, "shard_dim_alltoall", None) is original:
                    self._patched.append((module, original))
                    module.shard_dim_alltoall = alltoall
        _Propagation.enter()
        return super().__enter__()

    def __exit__(self, *exc):
        for module, original in self._patched:
            module.shard_dim_alltoall = original
        self._patched.clear()
        _Propagation.exit()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _on_dtensors(types):
            return NotImplemented
        out = func(*args, **kwargs)
        entry = self._table.get(func)
        if entry is not None and not self._inside and not _global(args, kwargs, out):
            kind, where, group = entry
            result = out if where == "out" else args[where]
            self.stats.add(kind, sum(_nbytes(t) for t in _tensors(result)),
                           _group_size(args[group]))
        return out


# Ops that move no bytes: views (``OpOverload.is_view``) and these.
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "device", "wait_tensor",
               "_wrap_tensor_autograd", "lift_fresh", "detach"}


class CostCounter(TorchDispatchMode):
    """Per-device FLOPs, bytes and peak live storage of the local ops (see
    the module docstring).  :meth:`add_arguments` registers the step's
    inputs first: their storages are the arguments, the rest are made by
    the step."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        from torch.utils.weak import WeakIdKeyDictionary

        self.flops = 0
        self.bytes = 0
        self.argument_bytes = 0
        self.live = 0              # bytes of storages made here, alive
        self.peak = 0
        self._registry = flop_registry
        self._seen = WeakIdKeyDictionary()

    def add_arguments(self, tensors: Iterable[torch.Tensor]) -> None:
        for t in tensors:
            s = t.untyped_storage()
            if s not in self._seen:
                self._seen[s] = True
                self.argument_bytes += s.nbytes()

    def __enter__(self):
        _Propagation.enter()
        return super().__enter__()

    def __exit__(self, *exc):
        _Propagation.exit()
        return super().__exit__(*exc)

    def is_argument(self, t: torch.Tensor) -> bool:
        return self._seen.get(t.untyped_storage(), False)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _on_dtensors(types):
            return NotImplemented
        if _global(args, kwargs):
            return func(*args, **kwargs)
        if _composite(func):
            with self:          # count the ops it is made of
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        if _global(out):
            return out
        packet = func.overloadpacket
        if packet in self._registry:
            self.flops += self._registry[packet](*args, **kwargs, out_val=out)
        outs = _tensors(out)
        if not func.is_view and packet.__name__ not in _NO_TRAFFIC:
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs)))) + sum(map(_nbytes, outs))
        for t in outs:
            s = t.untyped_storage()
            if s not in self._seen:
                self._seen[s] = False
                n = s.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(s, self._free, n)
        return out


def roofline_terms(
    hlo_flops: float,
    hlo_bytes: float,
    wire_bytes: float,
    hw: HW = HW(),
    n_links: int = 1,
) -> Dict[str, float]:
    """Three per-device roofline terms in seconds.

    ``hlo_flops``/``hlo_bytes`` come from :class:`CostCounter` (per device:
    the local ops of one rank); ``wire_bytes`` from
    :class:`CollectiveCounter`.  ``n_links`` is the links a GPU drives at
    once for a ring collective: one, its InfiniBand NIC (see :class:`HW`).
    """
    compute_s = hlo_flops / hw.peak_flops
    memory_s = hlo_bytes / hw.hbm_bw
    collective_s = wire_bytes / (hw.link_bw * n_links)
    dominant = max(
        ("compute", compute_s), ("memory", memory_s),
        ("collective", collective_s), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "bound_s": max(compute_s, memory_s, collective_s),
    }
