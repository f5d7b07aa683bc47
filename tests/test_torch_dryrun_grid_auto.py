"""The port's dry-run on the whole production grid at full size, under the
``auto`` layout (``launch/presets.py``): the checks of
tests/test_torch_dryrun_grid.py, one case per cell, in a file of its own so
that ``--dist loadfile`` runs the two layouts on two workers.

Every runnable cell is ``ok`` but mixtral-8x22b x train_4k: ``auto`` gives
it ``moe_ep``, which puts its 8 experts on the 16-rank "data" axis, and
``moe_apply_shardmap`` refuses, as the reference's ``shard_map`` refuses the
same cell ("axis sizes that are not evenly divisible", from
``python -m repro.launch.dryrun --layout auto``).  Every ``ok`` cell's
per-superblock and total FLOPs are at most the reference's record of the
same cell under ``auto`` (``REFERENCE_AUTO``): the prefill cells take
``seqpar``, whose q/k/v the attention keeps sharded on their sequence; and
so are its wire bytes.  Between the layers the port's ``seqpar`` stream
stays split on its sequence, a layout of its own (the reference's rule
gathers the sequence there, ``ActivationSharding.hidden``), as is its
one-row stream: those cells compare the port's layout's traffic with the
reference's.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import cell_runnable  # noqa: E402

from test_torch_dryrun_grid import (CELLS, check_grid_cell, check_under,  # noqa: E402,F401
                                    grid_record, production_mesh)

# (per_superblock.flops, hlo_flops, wire_bytes) of the reference's records,
# from
#   python -m repro.launch.dryrun --all --mesh single --roofline --layout auto
# (jax 0.9.0 on the CPU), for every cell that is ok there.
REFERENCE_AUTO = {
    ("arctic-480b", "decode_32k"): (27310149632.0, 943350112256.0, 110587333632.0),
    ("arctic-480b", "prefill_32k"): (10405872140288.0, 364208360259584.0, 653656392719.0),
    ("arctic-480b", "train_4k"): (18472639660032.0, 652283027128320.0, 456204011644.6875),
    ("gemma2-9b", "decode_32k"): (27898435328.0, 559963194624.0, 146044152320.0),
    ("gemma2-9b", "prefill_32k"): (7695066202112.0, 161610098278400.0, 121111708175.0),
    ("gemma2-9b", "train_4k"): (12402791809024.0, 283103570427904.0, 126432243719.53125),
    ("gemma3-12b", "decode_32k"): (29741468160.0, 211380489216.0, 56052123136.0),
    ("gemma3-12b", "prefill_32k"): (24324698275840.0, 194612278853632.0, 142888163599.0),
    ("gemma3-12b", "train_4k"): (41337009209344.0, 355335780958208.0, 160937687230.78125),
    ("internvl2-2b", "decode_32k"): (12270551520.0, 282731733312.0, 73608528384.0),
    ("internvl2-2b", "prefill_32k"): (1631287246848.0, 39157362327552.0, 31199164431.0),
    ("internvl2-2b", "train_4k"): (2746149240832.0, 70361437700096.0, 90958563230.5),
    ("mamba2-1.3b", "decode_32k"): (37548528.0, 1919593296.0, 341849408.0),
    ("mamba2-1.3b", "long_500k"): (1481822.0, 73411150.0, 1627663.5),
    ("mamba2-1.3b", "prefill_32k"): (262532792320.0, 12603389935616.0, 84127768576.0),
    ("mamba2-1.3b", "train_4k"): (963255205888.0, 48780744327168.0, 178533969182.0),
    ("mixtral-8x22b", "decode_32k"): (4341201920.0, 241804347392.0, 44320289536.0),
    ("mixtral-8x22b", "long_500k"): (140473292.0, 7774843304.0, 3373598127.5),
    ("mixtral-8x22b", "prefill_32k"): (12333959086080.0, 690704665804800.0, 733078497295.0),
    ("qwen2.5-32b", "decode_32k"): (13463537664.0, 850242167808.0, 204968149504.0),
    ("qwen2.5-32b", "prefill_32k"): (6785211039744.0, 434269394567168.0, 288099544079.0),
    ("qwen2.5-32b", "train_4k"): (13628841394176.0, 891474308759552.0, 434459289671.71875),
    ("recurrentgemma-9b", "decode_32k"): (775092992.0, 11007387221.333332, 2428304725.333333),
    ("recurrentgemma-9b", "long_500k"): (12735052.0, 185163174.66666666, 4498636.166666666),
    ("recurrentgemma-9b", "prefill_32k"): (7618097053696.0, 96506341927594.66, 72390247780.33333),
    ("recurrentgemma-9b", "train_4k"): (17916531572736.0, 252808242659328.0, 125531340258.28125),
    ("seamless-m4t-medium", "decode_32k"): (2557291456.0, 28917731456.0, 404827712.0),
    ("seamless-m4t-medium", "prefill_32k"): (2009417646080.0, 24113965957120.0, 94643894432.0),
    ("seamless-m4t-medium", "train_4k"): (2201161302016.0, 32744482537472.0, 100949889988.0),
    ("stablelm-1.6b", "decode_32k"): (1001718592.0, 23605524736.0, 1098179072.0),
    ("stablelm-1.6b", "prefill_32k"): (1551706619904.0, 37247571722240.0, 30131468333.0),
    ("stablelm-1.6b", "train_4k"): (2371673391104.0, 61814605873152.0, 129545867279.0),
}
# (arch, shape) -> what its error says, where the reference fails too.
ERRORS = {("mixtral-8x22b", "train_4k"):
          "ValueError: moe_apply_shardmap needs the batch split over the expert axis"}


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_auto_grid_cell(production_mesh, arch, shape):
    rec = grid_record(production_mesh, arch, shape, "auto")
    want = ("skipped" if not cell_runnable(arch, shape).runnable
            else "error" if (arch, shape) in ERRORS else "ok")
    check_grid_cell(rec, want)
    check_under(rec, REFERENCE_AUTO)
    if want == "error":
        assert rec["error"].startswith(ERRORS[arch, shape]), rec["error"]
