"""The counts against hand-worked operations and bytes of a tiny shape."""

from portbench import counts

TINY = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 2,
        "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
        "vocab_size": 10, "num_local_experts": 0, "num_experts_per_tok": 0,
        "sliding_window": None, "param_dtype": "float32", "compute_dtype": "bfloat16",
        "tie_word_embeddings": False, "norm": "rmsnorm", "use_qkv_bias": False}
MOE = dict(TINY, num_local_experts=4, num_experts_per_tok=2)


def test_pairs():
    assert counts.pairs(4) == 10                       # 1 + 2 + 3 + 4
    assert counts.pairs(5, window=2) == 1 + 2 + 2 + 2 + 2
    assert counts.pairs(3, window=8) == 6


def test_layer_params():
    # q 8x8, k 8x4, v 8x4, o 8x8 = 64 + 32 + 32 + 64; MLP 3 x 8 x 16 = 384
    assert counts.layer_params(TINY) == 192 + 384
    # two of four experts (2 x 384) and the router (8 x 4)
    assert counts.layer_params(MOE) == 192 + 768 + 32


def test_prefill_flops():
    # a 3-token request: per layer 2 x 3 x 576 + 4 x 4 x 2 x 6 pairs, two
    # layers; the head at the last token 2 x 8 x 10
    assert counts.prefill_flops(TINY, [3]) == 2 * (2 * 3 * 576 + 4 * 4 * 2 * 6) + 160


def test_flash_call():
    c = counts.flash_call(TINY, [3, 1])
    assert c["flops"] == 4 * 4 * 2 * (6 + 1)
    # q and out: 4 tokens x 2 heads x 4, k and v: 4 tokens x 1 head x 4, bf16
    assert c["bytes"] == 2 * (2 * 4 * 2 * 4 + 2 * 4 * 1 * 4)
    assert c["seconds"] == max(c["flops"] / counts.PEAK_BF16_FLOPS,
                               c["bytes"] / counts.HBM_BYTES_PER_S)


def test_decode_step():
    # every weight but the embedding, fp32: the head 8 x 256 (the vocabulary
    # padded to 256), the final norm's 8, and per layer two norms' 8, q, k,
    # v and o 64 + 32 + 32 + 64, the MLP's 3 x 128
    weights = counts.weight_bytes(TINY)
    assert weights == (2048 + 8 + 2 * (16 + 192 + 384)) * 4
    c = counts.decode_step(TINY, [5, 2], weights)
    assert c["flops"] == sum(2 * (2 * 576 + 4 * 4 * 2 * n) + 160 for n in (5, 2))
    # the weights, two looked-up rows of fp32 embedding, K/V of 7 positions
    # in two layers, one head of 4, bf16
    assert c["bytes"] == weights + 2 * 8 * 4 + 2 * 2 * 1 * 4 * 7 * 2
