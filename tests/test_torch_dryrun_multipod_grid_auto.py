"""The port's dry-run on the whole production grid at full size on the
multi-pod (2, 16, 16) mesh, under the ``auto`` layout: the checks of
tests/test_torch_dryrun_multipod_grid.py, one case per cell, against the
reference's records of
``python -m repro.launch.dryrun --all --mesh multi --roofline --layout auto``
(jax 0.9.0 on the CPU).  On this mesh ``auto`` is the only place where the
reference's ``zero3`` and ``moe_ep`` add sequence parallelism (train_4k's
256 rows do not cover 512 ranks: ``seq_axis="model"``,
``attn_shard_mode="seq"``).

Every runnable cell is ``ok`` but mixtral-8x22b x train_4k, where
``moe_apply_shardmap`` refuses 8 experts on 16 "data" ranks, as the
reference's ``shard_map`` does.  Before the repairs of this grid, six cells
were over the reference: gemma2-9b, gemma3-12b and recurrentgemma-9b at
train_4k (1.26x, 1.25x and 1.09x FLOPs: the output projection's backward,
left to DTensor, ran whole on every "model" rank; recurrentgemma also 1.24x
wire bytes, its gradients all-reduced over "pod" before their
reduce-scatter), arctic-480b and mixtral-8x22b at prefill_32k (1.28x and
1.18x FLOPs: at one row a rank, each "model" rank routed and dispatched
every token of its row) and arctic-480b at train_4k (1.004x FLOPs and 2.47x
wire bytes: each "model" rank ran every token group's experts).

arctic-480b x train_4k is held to the reference's count with the work its
parser leaves out: ``parse_collectives`` reads no tuple-shaped collective
(its shape pattern stops at the ``/*index=5*/`` comment of a long tuple),
and in this cell the reference's expert all-to-alls and some of its
combined gradient all-reduces are tuples (``REFERENCE_TUPLES``, from its
compiled HLO at one and two superblocks).  ``reference_with_tuples`` adds
their wire bytes, by the reference's formulas, to its two points and
extrapolates as ``run_cell_roofline`` does.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import cell_runnable, get_config  # noqa: E402

from test_torch_dryrun_grid import CELLS, check_grid_cell, grid_record  # noqa: E402
from test_torch_dryrun_grid_auto import ERRORS  # noqa: E402
from test_torch_dryrun_multipod_grid import (check_under_multi,  # noqa: E402,F401
                                             multipod_mesh)

# (per_superblock.flops, hlo_flops, wire_bytes, per_superblock.wire) of the
# reference's records, for every cell that is ok there.
REFERENCE_MULTI_AUTO = {
    ("arctic-480b", "decode_32k"): (13855176704.0, 478538926080.0, 56239957504.0, 1634416384.0),
    ("arctic-480b", "prefill_32k"): (4040932982784.0, 141434011254784.0, 1979514962439.5, 56529227776.0),
    ("arctic-480b", "train_4k"): (77131790942208.0, 2702440281407488.0, 238651855413.0, 5935464696.25),
    ("gemma2-9b", "decode_32k"): (13975655552.0, 280602252672.0, 74105074928.0, 3632754688.0),
    ("gemma2-9b", "prefill_32k"): (3848024096768.0, 80811093917696.0, 77032415495.5, 3626074112.0),
    ("gemma2-9b", "train_4k"): (6029214482432.0, 138043250966528.0, 336716048647.75, 13845381120.0),
    ("gemma3-12b", "decode_32k"): (14960204544.0, 106477801984.0, 29404836592.0, 3954104320.0),
    ("gemma3-12b", "prefill_32k"): (12163852795904.0, 97313584316416.0, 92772478087.5, 11476623360.0),
    ("gemma3-12b", "train_4k"): (20112163733504.0, 173295458582528.0, 388541182087.75, 42551377920.0),
    ("internvl2-2b", "decode_32k"): (6139489088.0, 141480877952.0, 37003485424.0, 1584035840.0),
    ("internvl2-2b", "prefill_32k"): (815777841152.0, 19581751656448.0, 18428709895.5, 753991680.0),
    ("internvl2-2b", "train_4k"): (1279507824640.0, 33024771096576.0, 43929647062.75, 1565574697.25),
    ("mamba2-1.3b", "decode_32k"): (20578360.0, 1054199936.0, 328305296.0, 6333406.0),
    ("mamba2-1.3b", "long_500k"): (1481823.0, 73411195.0, 1627663.5, 33237.0),
    ("mamba2-1.3b", "prefill_32k"): (131268149248.0, 6301793533952.0, 42234142720.0, 873592832.0),
    ("mamba2-1.3b", "train_4k"): (481643069440.0, 24391150206976.0, 89640324924.5, 1859092912.0),
    ("mixtral-8x22b", "decode_32k"): (2305482496.0, 128454827008.0, 33334917504.0, 596654192.0),
    ("mixtral-8x22b", "long_500k"): (141423692.0, 7827017000.0, 3344410031.5, 60777867.0),
    ("mixtral-8x22b", "prefill_32k"): (5197497630720.0, 291061517778944.0, 646939841543.5, 11537272832.0),
    ("qwen2.5-32b", "decode_32k"): (6764187776.0, 427251992320.0, 106232303856.0, 1673226240.0),
    ("qwen2.5-32b", "prefill_32k"): (3393193246720.0, 217165842612224.0, 205871859207.5, 3201024000.0),
    ("qwen2.5-32b", "train_4k"): (6708113965056.0, 438971481980928.0, 642160581127.75, 9547914240.0),
    ("recurrentgemma-9b", "decode_32k"): (431200256.0, 6131452245.333333, 2311454362.6666665, 163066240.0),
    ("recurrentgemma-9b", "long_500k"): (29137528.0, 392796762.6666666, 205064054.8333333, 16178429.0),
    ("recurrentgemma-9b", "prefill_32k"): (3809749499904.0, 48256604700672.0, 51758707378.166664, 3629142016.0),
    ("recurrentgemma-9b", "train_4k"): (8716239765504.0, 123415186898944.0, 177792317447.75, 10296729600.0),
    ("seamless-m4t-medium", "decode_32k"): (1278752224.0, 14462209728.0, 202413856.0, 16224480.0),
    ("seamless-m4t-medium", "prefill_32k"): (996970463232.0, 11964878290944.0, 13100002838.5, 1019412480.0),
    ("seamless-m4t-medium", "train_4k"): (1045422669824.0, 15765658927104.0, 38619309658.75, 2775045686.25),
    ("stablelm-1.6b", "decode_32k"): (504304064.0, 11900427840.0, 717713648.0, 27893760.0),
    ("stablelm-1.6b", "prefill_32k"): (775975272448.0, 18624142508032.0, 17344060438.5, 708034560.0),
    ("stablelm-1.6b", "train_4k"): (1112402034688.0, 29213333651456.0, 62798778988.25, 2442660984.25),
}
# arctic-480b x train_4k: the wire bytes of the reference's record at one
# and two superblocks (its "points"), and the tuple-shaped collectives of
# the same compiled HLO that its parser skips: (kind, result bytes of the
# whole tuple, replica group size, how many), from
#   compiled.as_text() of the cell's 1- and 2-superblock train steps.
# The expert dispatch's all-to-alls, 16 x f32[8,640,7168] each (one a
# rank of the "data" axis: 8 of the 128 experts, 640 slots, d_model), run
# twice a layer forward, twice in the rematerialized forward and twice in
# the backward; the all-reduces are XLA's combined gradient reductions.
ARCTIC_TRAIN = ("arctic-480b", "train_4k")
REFERENCE_POINTS_WIRE = (36846055740.5, 42781520436.75)
_A2A = ("all-to-all", 16 * 8 * 640 * 7168 * 4, 16)
REFERENCE_TUPLES = (
    [_A2A + (6,),
     ("all-reduce", 5963776, 2, 1), ("all-reduce", 40, 256, 1),
     ("all-to-all", 802816, 256, 2)],
    [_A2A + (12,),
     ("all-reduce", 6694109184, 32, 1), ("all-reduce", 1159725056, 256, 1),
     ("all-reduce", 8343552, 2, 1), ("all-reduce", 1475461120, 16, 1),
     ("all-reduce", 917647364, 32, 1), ("all-reduce", 40, 256, 1),
     ("all-to-all", 1605632, 256, 2)],
)


def _wire(kind: str, result_bytes: float, n: int) -> float:
    """The reference's per-device wire bytes of one collective."""
    frac = (n - 1) / n
    return {"all-reduce": 2.0 * result_bytes * frac, "reduce-scatter": result_bytes * (n - 1),
            "all-gather": result_bytes * frac, "all-to-all": result_bytes * frac}[kind]


def reference_with_tuples() -> tuple:
    """arctic-480b x train_4k's reference record with its tuple-shaped
    collectives counted: (per-superblock wire, wire bytes), extrapolated
    from the two points as ``run_cell_roofline`` does."""
    p1, p2 = (w + sum(_wire(k, b, n) * count for k, b, n, count in tuples)
              for w, tuples in zip(REFERENCE_POINTS_WIRE, REFERENCE_TUPLES))
    cfg = get_config("arctic-480b")
    reps = cfg.n_layers / len(cfg.pattern)
    return p2 - p1, p1 + (p2 - p1) * (reps - 1)


def test_arctic_train_reference_with_tuples():
    """The record's own points give its per-superblock wire bytes, and the
    counted tuples raise it to the count with that work done."""
    per, ref_flops, wire, ref_per_wire = REFERENCE_MULTI_AUTO[ARCTIC_TRAIN]
    p1, p2 = REFERENCE_POINTS_WIRE
    assert p2 - p1 == ref_per_wire and p1 + (p2 - p1) * 34 == wire
    per_wire, total = reference_with_tuples()
    assert 6 * _wire(*_A2A) == pytest.approx(1.321206e10, rel=1e-6)
    assert per_wire == pytest.approx(3.897616e10, rel=1e-6)
    assert total == pytest.approx(1.375255e12, rel=1e-6)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_multipod_auto_grid_cell(multipod_mesh, arch, shape):
    rec = grid_record(multipod_mesh, arch, shape, "auto")
    want = ("skipped" if not cell_runnable(arch, shape).runnable
            else "error" if (arch, shape) in ERRORS else "ok")
    check_grid_cell(rec, want)
    reference = REFERENCE_MULTI_AUTO
    if (arch, shape) == ARCTIC_TRAIN:
        per, flops, _, _ = reference[ARCTIC_TRAIN]
        per_wire, wire = reference_with_tuples()
        reference = {ARCTIC_TRAIN: (per, flops, wire, per_wire)}
    check_under_multi(rec, reference, "auto")
    if want == "error":
        assert rec["error"].startswith(ERRORS[arch, shape]), rec["error"]
