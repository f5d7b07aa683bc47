"""The port's dry-run on the whole production grid at full size, under the
``baseline`` layout: ``run_cell_roofline`` of every (arch x shape) cell on
the fake 16 x 16 ("data", "model") mesh of a 256-rank fake process group,
the mesh claiming ``cpu`` (the ``auto`` layout's grid is in
tests/test_torch_dryrun_grid_auto.py).

- A cell is ``skipped`` exactly where ``cell_runnable`` says so (the
  quadratic-attention archs at long_500k: 7 of 40), else ``ok``.
- An ``ok`` cell's per-superblock FLOPs, bytes and wire bytes are positive
  (for a deeper model, a shallower graph must not count more), and so is
  every roofline term; its useful-FLOPs ratio lies in (0, 1.05] (decode
  cells read up to 1.044: the model's count adds the attention over the
  whole context, which the traced step also runs).
- Every ``ok`` cell's ``per_superblock.flops`` and ``hlo_flops`` are at
  most the reference's (``REFERENCE``).  XLA's ``cost_analysis`` counts
  elementwise work as well as the matmuls that the port counts, so the
  reference's count is a superset of the port's for the same sharding.
  Among them: qwen2.5-32b's 40 and arctic-480b's 56 q heads, which 16
  "model" ranks do not divide (the attention splits the query rows there),
  and mamba2-1.3b's and recurrentgemma-9b's long_500k at one row (the
  weights keep their FSDP shard on "data").
- Every ``ok`` cell's ``wire_bytes`` (the bytes a device moves in
  collectives, by the reference's formulas) are at most the reference's:
  the port's layouts move no more than GSPMD's.  At one token a row (the
  decode and long_500k cells) the port's residual stream is its own layout,
  not the reference's: split on d_model where the weights keep their FSDP
  shard (``ActivationSharding.hidden``), so those cells compare that
  layout's traffic with the reference's (batch, None, tp) stream.

One case per cell.  The records are traced once per cell and layout
(``grid_record``), on the module's fake group, destroyed at its end.
"""

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ARCHS, SHAPES, cell_runnable, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

CELLS = [(arch, shape) for arch in ARCHS for shape in SHAPES]
MAX_USEFUL_RATIO = 1.05
# (per_superblock.flops, hlo_flops, wire_bytes) of the reference's records,
# from
#   python -m repro.launch.dryrun --all --mesh single --roofline
# (jax 0.9.0 on the CPU), for every runnable cell.  The port's wire bytes
# were over the reference's on 9 of these cells (up to 144x at long_500k)
# before its decode states, KV caches and weights at one token a row stayed
# where they lie.  mamba2-1.3b x train_4k
# is the one whose port count was negative (-7.5605e12 a superblock) and
# then 9.4x the reference's at full depth; the heads of qwen2.5-32b and
# arctic-480b and the one row of long_500k made the port count 1.7-7.0x the
# reference's before its query rows split and its weights kept their FSDP
# shard at one row.
REFERENCE = {
    ("arctic-480b", "prefill_32k"): (10489461473280.0, 367141576507392.0, 2808320327680.0),
    ("arctic-480b", "train_4k"): (29308095561728.0, 1023714550349824.0, 2154320455693.0),
    ("arctic-480b", "decode_32k"): (27310149632.0, 943350112256.0, 110587333632.0),
    ("gemma2-9b", "decode_32k"): (27898435328.0, 559963194624.0, 146044152320.0),
    ("gemma2-9b", "prefill_32k"): (7715708469248.0, 162053190844416.0, 157543874560.0),
    ("gemma2-9b", "train_4k"): (16240743546880.0, 363378509873152.0, 694838667542.5),
    ("gemma3-12b", "decode_32k"): (29741468160.0, 211380489216.0, 56052123136.0),
    ("gemma3-12b", "prefill_32k"): (24384884441088.0, 195103570264064.0, 192285442048.0),
    ("gemma3-12b", "train_4k"): (57355010048000.0, 480359074496512.0, 849228984500.5),
    ("internvl2-2b", "decode_32k"): (12270551520.0, 282731733312.0, 73608528384.0),
    ("internvl2-2b", "prefill_32k"): (1636827004928.0, 39293252796416.0, 51306610688.0),
    ("internvl2-2b", "train_4k"): (2746149240832.0, 70361437700096.0, 90958563230.5),
    ("mamba2-1.3b", "decode_32k"): (37548528.0, 1919593296.0, 341849408.0),
    ("mamba2-1.3b", "long_500k"): (1481822.0, 73411150.0, 1627663.5),
    ("mamba2-1.3b", "prefill_32k"): (262532792320.0, 12603389935616.0, 84127768576.0),
    ("mamba2-1.3b", "train_4k"): (963255205888.0, 48780744327168.0, 178533969182.0),
    ("mixtral-8x22b", "decode_32k"): (4341201920.0, 241804347392.0, 44320289536.0),
    ("mixtral-8x22b", "long_500k"): (140473292.0, 7774843304.0, 3373598127.5),
    ("mixtral-8x22b", "prefill_32k"): (12342414802944.0, 691185945411584.0, 631903354880.0),
    ("mixtral-8x22b", "train_4k"): (38699328864256.0, 2166130684723200.0, 1380154800680.5),
    ("qwen2.5-32b", "decode_32k"): (13463537664.0, 850242167808.0, 204968149504.0),
    ("qwen2.5-32b", "prefill_32k"): (6843988967424.0, 438035504168960.0, 3104541007872.0),
    ("qwen2.5-32b", "train_4k"): (16892957818880.0, 1099754440228864.0, 1631423956995.5),
    ("recurrentgemma-9b", "decode_32k"): (775092992.0, 11007387221.333332, 2428304725.333333),
    ("recurrentgemma-9b", "long_500k"): (12735052.0, 185163174.66666666, 4498636.166666666),
    ("recurrentgemma-9b", "prefill_32k"): (7625806708736.0, 96615988024661.33, 184448166570.66666),
    ("recurrentgemma-9b", "train_4k"): (24189603938304.0, 330576695394304.0, 512848807871.0),
    ("seamless-m4t-medium", "decode_32k"): (2557291456.0, 28917731456.0, 404827712.0),
    ("seamless-m4t-medium", "prefill_32k"): (10488734810112.0, 125868659703808.0, 104093297104.0),
    ("seamless-m4t-medium", "train_4k"): (2201161302016.0, 32744482537472.0, 100949889988.0),
    ("stablelm-1.6b", "decode_32k"): (1001718592.0, 23605524736.0, 1098179072.0),
    ("stablelm-1.6b", "prefill_32k"): (1558217752576.0, 37407714967552.0, 49666392064.0),
    ("stablelm-1.6b", "train_4k"): (2371673391104.0, 61814605873152.0, 129545867279.0),
}


@pytest.fixture(scope="module")
def production_mesh():
    """The 16 x 16 mesh on a fake group of 256 ranks, for the module."""
    with dryrun.fake_process_group(256):
        yield make_production_mesh(device_type="cpu")
    assert not dist.is_initialized()


def grid_record(mesh, arch: str, shape: str, layout: str) -> dict:
    """``run_cell_roofline`` of one cell under ``layout``, as the command
    line runs it."""
    rules = rt_over = None
    if layout != "baseline":
        from repro_torch.launch.presets import resolve_layout
        rules, rt_over, _ = resolve_layout(get_config(arch), SHAPES[shape], mesh, layout)
    return dryrun.run_cell_roofline(arch, shape, mesh, rules=rules, rt_overrides=rt_over)


def check_grid_cell(rec: dict, want: str) -> None:
    """The status ``want``; an ``ok`` cell's counts and terms positive and
    its useful-FLOPs ratio in (0, 1.05]."""
    assert rec["status"] == want, rec.get("traceback", rec.get("error"))
    if want != "ok":
        return
    per = rec["per_superblock"]
    assert per["flops"] > 0 and per["bytes"] > 0 and per["wire"] > 0, per
    r = rec["roofline"]
    for term in ("compute_s", "memory_s", "collective_s", "memory_model_s", "bound_s"):
        assert r[term] > 0, (term, r)
    assert 0 < rec["useful_flops_ratio"] <= MAX_USEFUL_RATIO, rec["useful_flops_ratio"]


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_baseline_grid_cell(production_mesh, arch, shape):
    rec = grid_record(production_mesh, arch, shape, "baseline")
    check_grid_cell(rec, "ok" if cell_runnable(arch, shape).runnable else "skipped")
    check_under(rec, REFERENCE)


def check_under(rec: dict, reference: dict) -> None:
    """An ``ok`` cell's per-superblock and total FLOPs and its wire bytes
    at most the reference's record of the same cell."""
    if rec["status"] != "ok":
        return
    ref_per, ref_flops, ref_wire = reference[rec["arch"], rec["shape"]]
    assert rec["per_superblock"]["flops"] <= ref_per, (rec["per_superblock"], ref_per)
    assert rec["hlo_flops"] <= ref_flops, (rec["hlo_flops"], ref_flops)
    assert rec["wire_bytes"] <= ref_wire, (rec["wire_bytes"], ref_wire)


def test_the_grid_has_33_runnable_cells():
    assert len(CELLS) == 40
    assert sum(cell_runnable(a, s).runnable for a, s in CELLS) == 33
    assert len(REFERENCE) == 33
