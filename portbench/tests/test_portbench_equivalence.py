"""The counts and the readers of the real configuration read what they read
before the architecture moved into the configuration's reference module:
constants worked out by the formulas as they stood in ``counts.py`` and the
readers, on the real ``mixtral-8x22b-d8`` file and on the metrics test's
records."""

import json

import pytest

from portbench import counts, harness
from portbench.tests.test_portbench_metrics import TRACE, rec, read

MIXTRAL = json.loads((harness.BENCH / "configs" / "mixtral-8x22b-d8.json").read_text())

PREFILL = {(256,): 2841750011904, (4000,): 45868655837184,
           (3832, 2961, 1000, 256): 91545154289664, (1, 2, 3): 67652419584}
FLASH = {(256,): (808452096, 7340032), (4000,): (196657152000, 114688000),
         (3832, 2961, 1000, 256): (301367255040, 230780928), (1, 2, 3): (245760, 172032)}
DECODE = {(129,): (11501764608, 40472666112),
          (1025, 300, 2000): (35082928128, 40577417216),
          (4001,) * 24: (294312738816, 43615236096)}

# every per-layer reader on rec(TRACE), with the counts test's tiny config
# and with the real one (None: the records hold nothing it reads)
READINGS = {
    "engine.pad_share.eval": (31.25, 31.25),
    "engine.decode_ms_per_step.gen": (100.00000000000001, 100.00000000000001),
    "engine.active_row_share.gen": (50.0, 50.0),
    "prefill_mfu": (3.710144927536232e-09, 0.016639915098078866),
    "decode_step_roofline_share": (3.929154228855721e-06, 12.080183224676617),
    "flash_fwd_wgmma_roofline": (15.761194029850744, 37658.746268656716),
    "device_idle_share.eval": (25.0, 25.0),
    "device_idle_share.gen": (25.0, 25.0),
    "engine.queue_ms_p95.eval": (None, None),
    "model.moe_ms_per_step.gen": (None, None),
    "model.attn_ms_per_step.gen": (None, None),
    "model.moe_us_per_prompt_token.eval": (None, None),
    "moe.slot_use.eval": (None, None),
}


def test_weights_and_layer():
    assert counts.weight_bytes(MIXTRAL) == 40468426752
    assert counts.layer_params(MIXTRAL) == 692109312


@pytest.mark.parametrize("lens", list(PREFILL), ids=str)
def test_prefill_and_flash(lens):
    assert counts.prefill_flops(MIXTRAL, lens) == PREFILL[lens]
    c = counts.flash_call(MIXTRAL, lens)
    assert (c["flops"], c["bytes"]) == FLASH[lens]
    assert c["seconds"] == max(c["flops"] / counts.PEAK_BF16_FLOPS,
                               c["bytes"] / counts.HBM_BYTES_PER_S)


@pytest.mark.parametrize("contexts", list(DECODE), ids=lambda c: f"{len(c)}x{c[0]}")
def test_decode_step(contexts):
    c = counts.decode_step(MIXTRAL, contexts, counts.weight_bytes(MIXTRAL))
    assert (c["flops"], c["bytes"]) == DECODE[contexts]


def test_every_per_layer_metric_is_listed():
    # later cells may add metrics; the ones above stay
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert set(READINGS) <= {m["name"] for m in bench["per_layer"]}


@pytest.mark.parametrize("name", list(READINGS))
@pytest.mark.parametrize("config", ["tiny", "mixtral"])
def test_reader(name, config):
    records = rec(TRACE)
    if config == "mixtral":
        records["config"] = MIXTRAL
    assert read(name, records) == READINGS[name][config == "mixtral"]
