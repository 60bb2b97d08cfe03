"""Operation and byte counts against hand counts at small shapes."""
import flops

RUN = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
       "head_dim": 2, "d_ff": 16, "vocab": 10}


def test_bench_layer_params_by_hand():
    # wq 8x8, wk 8x4, wv 8x4, wo 8x8, gate / up 8x16, down 16x8
    assert flops.layer_weight_params(RUN) == 64 + 32 + 32 + 64 + 3 * 128


def test_bench_causal_pairs_by_hand():
    assert flops.causal_pairs(3, 0) == 1 + 2 + 3
    assert flops.causal_pairs(2, 5) == 6 + 7
    assert flops.causal_pairs(1, 0) == 1


def test_bench_prefill_and_decode_flops_by_hand():
    per_tok = 2 * 2 * (64 + 32 + 32 + 64 + 384)     # 2 x layers x params
    pair = 4 * 2 * 4                                 # 4 Dh heads
    head = 2 * 8 * 10
    # 3 tokens computed after 5 served: pairs 6 + 7 + 8 a layer
    assert flops.prefill_flops(RUN, 3, 5) == 3 * per_tok + 2 * pair * 21 \
        + head
    # two streams of 4 and 9 tokens: 5 + 10 keys
    assert flops.decode_flops(RUN, [4, 9]) == 2 * per_tok + 2 * pair * 15 \
        + 2 * head


def test_bench_k4_work_by_hand():
    f, b = flops.k4_work(RUN, [3, 1])
    assert f == 32 * (4 + 2)
    # rows: (3 + 1) tokens x K,V x 2 heads x 2 dims; a stream: q and out
    # (4 heads x 2) and the fresh k, v (2 x 2): bf16
    assert b == 2 * (4 * 2 * 2 * 2 + 2 * (2 * 8 + 2 * 4))


def test_bench_k6_work_by_hand():
    f, b = flops.k6_work(RUN, 4, 2, 6)
    assert f == 32 * (4 * 2 + 10)
    assert b == 2 * 2 * (2 * 4 * 4 + 2 * 2 * 6)


def test_bench_least_seconds_takes_the_longer_bound():
    assert flops.least_seconds(989e12, 0) == 1.0
    assert flops.least_seconds(0, 3.35e12) == 1.0
    assert flops.least_seconds(989e12, 2 * 3.35e12) == 2.0
