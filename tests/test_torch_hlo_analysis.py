"""The port's dispatch-trace analysis (``repro_torch.launch.hlo_analysis``)
against the reference's HLO analysis (``repro.launch.hlo_analysis``).

- ``roofline_terms`` on the H100 constants, as tests/test_sharding_and_hlo.py
  holds the reference's on TPU v5e's;
- each collective kind run on ``meta`` tensors over a fake process group:
  the counter's kind, count and wire bytes equal ``parse_collectives`` on an
  HLO line of the same result shape and group size;
- a Shard(0) -> Shard(1) redistribute on a fake ``cpu`` mesh counts as one
  all-to-all (DTensor runs it there as an all-gather and a chunk);
- the per-device FLOPs of a DTensor matmul on a fake 16 x 16 mesh are the
  local op's 2 * 16 * 4096 * 1024 = 134,217,728, not the 34,493,956,096 that
  counting the global op beside it gives;
- the peak live bytes follow storages as they are made and freed.

Each test makes its own fake process group and destroys it.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.launch.hlo_analysis import parse_collectives  # noqa: E402
from repro_torch.launch.dryrun import fake_process_group  # noqa: E402
from repro_torch.launch.hlo_analysis import (CARD, HW, CollectiveCounter,  # noqa: E402
                                             CostCounter, roofline_terms,
                                             wire_bytes)


def test_hw_is_the_h100_sxm5():
    hw = HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989.4e12, 3.35e12, 50e9)
    assert CARD == "NVIDIA H100 80GB HBM3, 700.00 W"


def test_roofline_terms_dominant():
    t = roofline_terms(989.4e12, 3.35e12 * 2, 0.0, HW())
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["dominant"] == "memory"
    assert t["bound_s"] == pytest.approx(2.0)
    t = roofline_terms(0.0, 0.0, 50e9 * 3, HW())
    assert t["collective_s"] == pytest.approx(3.0)      # one link a GPU
    assert t["dominant"] == "collective"


def _hlo_line(kind: str, shape, n: int, dtype: str = "f32") -> str:
    dims = ",".join(map(str, shape))
    return (f"  %{kind}.1 = {dtype}[{dims}]{{1,0}} {kind}(%x), channel_id=1, "
            f"replica_groups=[{8 // n},{n}]<=[8], dimensions={{0}}")


def _run(kind: str, mesh, x):
    import torch.distributed._functional_collectives as funcol

    group = (mesh, 0)
    if kind == "all-reduce":
        return funcol.all_reduce(x, "sum", group)
    if kind == "all-gather":
        return getattr(funcol, "all_gather_single", funcol.all_gather_tensor)(x, 0, group)
    if kind == "reduce-scatter":
        return getattr(funcol, "reduce_scatter_single", funcol.reduce_scatter_tensor)(x, "sum", 0, group)
    return funcol.all_to_all_single(x, None, None, group)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter",
                                  "all-to-all"])
def test_counter_wire_bytes_equal_the_reference_parser(kind, n):
    from torch.distributed.device_mesh import init_device_mesh

    with fake_process_group(8):
        mesh = init_device_mesh("cpu", (8 // n, n), mesh_dim_names=("a", "b"))["b"]
        x = torch.empty(16, 128, device="meta")
        with CollectiveCounter() as counter:
            out = _run(kind, mesh, x)
            if hasattr(out, "wait"):
                out = out.wait()
        stats = counter.stats
    want = parse_collectives(_hlo_line(kind, tuple(out.shape), n))
    assert stats.counts == want.counts == {kind: 1}
    assert stats.bytes_by_kind[kind] == pytest.approx(want.bytes_by_kind[kind])
    assert stats.total_wire_bytes == pytest.approx(want.total_wire_bytes)


def test_collective_permute_wire_bytes_equal_the_reference_parser():
    line = "  %cp.1 = f32[4,4]{1,0} collective-permute(%z), source_target_pairs={{0,1}}"
    assert wire_bytes("collective-permute", 64, 2) == \
        parse_collectives(line).total_wire_bytes == 64


def test_shard_to_shard_on_a_cpu_mesh_is_one_all_to_all():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    with fake_process_group(4):
        mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("x",))
        t = DTensor.from_local(torch.empty(8, 32, device="meta"), mesh, [Shard(0)],
                               run_check=False)
        with CollectiveCounter() as counter:
            out = t.redistribute(mesh, [Shard(1)])
        stats = counter.stats
    assert tuple(out.to_local().shape) == (32, 8)
    assert stats.counts == {"all-to-all": 1}
    assert stats.total_wire_bytes == pytest.approx(32 * 8 * 4 * 3 / 4)


def test_dtensor_matmul_counts_the_local_flops_only():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    with fake_process_group(256):
        mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
        x = DTensor.from_local(torch.empty(16, 4096, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)
        w = DTensor.from_local(torch.empty(4096, 1024, device="meta"), mesh,
                               [Replicate(), Shard(1)], run_check=False)
        with CostCounter() as cost:
            y = x @ w
    assert tuple(y.shape) == (256, 16384)
    assert cost.flops == 2 * 16 * 4096 * 1024 == 134_217_728
    assert cost.flops != 34_493_956_096


def test_cost_counter_bytes_and_peak_follow_storages():
    a = torch.empty(1024, device="meta")                   # 4 KiB, an argument
    with CostCounter() as cost:
        cost.add_arguments([a])
        b = a * 2                                          # +4 KiB
        c = b.view(32, 32)                                 # a view: no bytes, no storage
        d = c + 1                                          # +4 KiB (peak 8 KiB)
        del b, c
        e = d.sum()                                        # +4 B
    assert cost.argument_bytes == 4096
    assert cost.bytes == (4096 + 4096) + (4096 + 4096) + (4096 + 4)
    assert cost.peak == 8192
    assert cost.live == 4096 + 4
    assert not cost.is_argument(e) and cost.is_argument(a)
    assert not dist.is_initialized()
