"""The port's dry-run on the whole production grid at full size on the
multi-pod mesh, under the ``baseline`` layout: ``run_cell_roofline`` of
every (arch x shape) cell on the fake (2, 16, 16) ("pod", "data", "model")
mesh of a 512-rank fake process group, the mesh claiming ``cpu`` (the
``auto`` layout's grid is in tests/test_torch_dryrun_multipod_grid_auto.py;
the 16 x 16 grids in tests/test_torch_dryrun_grid*.py).

- A cell is ``skipped`` exactly where ``cell_runnable`` says so (7 of 40),
  else ``ok``; an ``ok`` cell's per-superblock counts and roofline terms
  are positive and its useful-FLOPs ratio lies in (0, 1.05]
  (``check_grid_cell``).
- Every ``ok`` cell's ``per_superblock.flops``, ``hlo_flops``,
  ``wire_bytes`` and ``per_superblock.wire`` are at most the reference's
  record of the same cell (``REFERENCE_MULTI``), from

      python -m repro.launch.dryrun --all --mesh multi --roofline

  (jax 0.9.0 on the CPU).  The ``collective_s`` terms are not compared:
  the port divides by one InfiniBand link, the reference by four ICI links.
- seamless-m4t-medium x prefill_32k is the exception: the reference's
  2-point extrapolation reads negative FLOPs there (-3.0334e13 in all,
  -3.2343e12 a superblock), so the port's are held positive and at most
  the reference's record of the same cell under ``auto``
  (``SEAMLESS_PREFILL_FLOPS``: 1.1965e13 and 9.9697e11); its wire bytes are
  held as everywhere else.

Before the repairs of the multi-pod grid, internvl2-2b x train_4k moved
1.006x the reference's wire bytes (1.154x a superblock: its 8 KV heads,
which 16 "model" ranks do not divide, were gathered whole, now each rank
takes its q heads' K/V from the two ranks that hold them,
``kernels/_local.py::repeat_heads``) and arctic-480b x decode_32k 1.013x
(every rank gathered all 128 experts' weights each step; the experts now
stay on their "data" ranks and the rows come to them,
``models/moe.py::_moe_decode_ep``).

One case per cell.  The records are traced once per cell, on the module's
fake group, destroyed at its end.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import cell_runnable  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

from test_torch_dryrun_grid import CELLS, check_grid_cell, grid_record  # noqa: E402

# (per_superblock.flops, hlo_flops, wire_bytes, per_superblock.wire) of the
# reference's records, for every cell that is ok there.
REFERENCE_MULTI = {
    ("arctic-480b", "decode_32k"): (13855176704.0, 478538926080.0, 56239957504.0, 1634416384.0),
    ("arctic-480b", "prefill_32k"): (5246839422976.0, 183645541236736.0, 1469498490880.0, 41957330944.0),
    ("arctic-480b", "train_4k"): (14660706238464.0, 512086827335680.0, 1308827973406.5, 36473314761.25),
    ("gemma2-9b", "decode_32k"): (13975655552.0, 280602252672.0, 74105074928.0, 3632754688.0),
    ("gemma2-9b", "prefill_32k"): (3858955239424.0, 81048973606912.0, 79641755648.0, 3750330368.0),
    ("gemma2-9b", "train_4k"): (7958664577024.0, 178258458968064.0, 349058940973.25, 16516907008.0),
    ("gemma3-12b", "decode_32k"): (14960204544.0, 106477801984.0, 29404836592.0, 3954104320.0),
    ("gemma3-12b", "prefill_32k"): (12193611382784.0, 97560073076736.0, 97299136512.0, 12042461184.0),
    ("gemma3-12b", "train_4k"): (28157847535616.0, 235984637657088.0, 426446733319.75, 53007826944.0),
    ("internvl2-2b", "decode_32k"): (6139489088.0, 141480877952.0, 37003485424.0, 1584035840.0),
    ("internvl2-2b", "prefill_32k"): (819491635200.0, 19673357221888.0, 25651277824.0, 1054932992.0),
    ("internvl2-2b", "train_4k"): (1279507824640.0, 33024771096576.0, 43929647062.75, 1565574697.25),
    ("mamba2-1.3b", "decode_32k"): (20578360.0, 1054199936.0, 328305296.0, 6333406.0),
    ("mamba2-1.3b", "long_500k"): (1481823.0, 73411195.0, 1627663.5, 33237.0),
    ("mamba2-1.3b", "prefill_32k"): (131268149248.0, 6301793533952.0, 42234142720.0, 873592832.0),
    ("mamba2-1.3b", "train_4k"): (481643069440.0, 24391150206976.0, 89640324924.5, 1859092912.0),
    ("mixtral-8x22b", "decode_32k"): (2305482496.0, 128454827008.0, 33334917504.0, 596654192.0),
    ("mixtral-8x22b", "long_500k"): (141423692.0, 7827017000.0, 3344410031.5, 60777867.0),
    ("mixtral-8x22b", "prefill_32k"): (6171390902272.0, 345605943590912.0, 333377961984.0, 5937954816.0),
    ("mixtral-8x22b", "train_4k"): (19351040163840.0, 1083141812912128.0, 750580584966.25, 12964791721.25),
    ("qwen2.5-32b", "decode_32k"): (6764187776.0, 427251992320.0, 106232303856.0, 1673226240.0),
    ("qwen2.5-32b", "prefill_32k"): (3423101255680.0, 219083123458048.0, 1555582050304.0, 24290246656.0),
    ("qwen2.5-32b", "train_4k"): (8212698890240.0, 535136737165312.0, 798904976340.25, 12233186590.75),
    ("recurrentgemma-9b", "decode_32k"): (431200256.0, 6131452245.333333, 2311454362.6666665, 163066240.0),
    ("recurrentgemma-9b", "long_500k"): (29137528.0, 392796762.6666666, 205064054.8333333, 16178429.0),
    ("recurrentgemma-9b", "prefill_32k"): (3812949229568.0, 48306115138901.33, 93078050133.33333, 7268433920.0),
    ("recurrentgemma-9b", "train_4k"): (11603938377728.0, 159546204312917.3, 258661343269.75, 18237751296.0),
    ("seamless-m4t-medium", "decode_32k"): (1278752224.0, 14462209728.0, 202413856.0, 16224480.0),
    ("seamless-m4t-medium", "prefill_32k"): (-3234315632640.0, -30334261133312.0, 17867743232.0, 1392967680.0),
    ("seamless-m4t-medium", "train_4k"): (1045422669824.0, 15765658927104.0, 38619309658.75, 2775045686.25),
    ("stablelm-1.6b", "decode_32k"): (504304064.0, 11900427840.0, 717713648.0, 27893760.0),
    ("stablelm-1.6b", "prefill_32k"): (780186222592.0, 18728149843968.0, 24799412224.0, 1018675200.0),
    ("stablelm-1.6b", "train_4k"): (1112402034688.0, 29213333651456.0, 62798778988.25, 2442660984.25),
}
# The reference's seamless-m4t-medium x prefill_32k under ``auto``: (per
# superblock, in all) FLOPs, which bound the port's under ``baseline``.
SEAMLESS_PREFILL_FLOPS = (996970463232.0, 11964878290944.0)


@pytest.fixture(scope="module")
def multipod_mesh():
    """The (2, 16, 16) mesh on a fake group of 512 ranks, for the module."""
    with dryrun.fake_process_group(512):
        yield make_production_mesh(multi_pod=True, device_type="cpu")
    assert not dist.is_initialized()


def check_under_multi(rec: dict, reference: dict, layout: str) -> None:
    """An ``ok`` cell's per-superblock and total FLOPs and wire bytes at
    most the reference's record of the same cell (``reference``: per
    superblock FLOPs, FLOPs, wire bytes, per-superblock wire bytes), but
    seamless prefill_32k's FLOPs under ``baseline``, which are held to
    ``SEAMLESS_PREFILL_FLOPS``."""
    if rec["status"] != "ok":
        return
    key = rec["arch"], rec["shape"]
    ref_per, ref_flops, ref_wire, ref_per_wire = reference[key]
    if layout == "baseline" and key == ("seamless-m4t-medium", "prefill_32k"):
        assert ref_per < 0 and ref_flops < 0
        ref_per, ref_flops = SEAMLESS_PREFILL_FLOPS
    per = rec["per_superblock"]
    assert 0 < per["flops"] <= ref_per, (per, ref_per)
    assert 0 < rec["hlo_flops"] <= ref_flops, (rec["hlo_flops"], ref_flops)
    assert rec["wire_bytes"] <= ref_wire, (rec["wire_bytes"], ref_wire)
    assert per["wire"] <= ref_per_wire, (per["wire"], ref_per_wire)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_multipod_baseline_grid_cell(multipod_mesh, arch, shape):
    rec = grid_record(multipod_mesh, arch, shape, "baseline")
    assert rec["mesh"] == "2x16x16"
    check_grid_cell(rec, "ok" if cell_runnable(arch, shape).runnable else "skipped")
    check_under_multi(rec, REFERENCE_MULTI, "baseline")
