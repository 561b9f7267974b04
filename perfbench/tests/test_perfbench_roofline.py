"""The benchmark's frozen work counts against hand counts at tiny shapes,
and the model FLOPs of ``jamba_v01_16L`` at 4,096 tokens."""

import pytest

from perfbench.harness import spec
from perfbench.roofline import peaks, work

TINY = {"family": "moe", "num_layers": 2, "d_model": 8, "num_heads": 4,
        "num_kv_heads": 2, "head_dim": 2, "d_ff": 0, "vocab_size": 10,
        "sliding_window": None,
        "moe": {"num_experts": 3, "top_k": 2, "d_ff_expert": 5,
                "every_n_layers": 1}}


def test_gmm_hand_count():
    # S 4 tokens x top 2 = 8 rows; D 8, F 5, E 3
    up, up2, down = work.gmm_calls(TINY, 4)
    assert up == up2 == (2 * 8 * 8 * 5, 2 * (3 * 8 * 5 + 8 * 8 + 8 * 5))
    assert down == (2 * 8 * 5 * 8, 2 * (3 * 5 * 8 + 8 * 5 + 8 * 8))


def test_flash_hand_count():
    # S 3 causal: pairs 1 + 2 + 3 = 6; 4 hd FLOPs a pair a head
    assert work.flash_call(TINY, 3) == (4 * 2 * 4 * 6,
                                        2 * (2 * 4 * 3 * 2 + 2 * 2 * 3 * 2))
    assert work.causal_pairs(5, window=2) == 1 + 2 + 2 + 2 + 2


def test_ssd_hand_count():
    cfg = {"d_model": 4, "ssm": {"expand": 2, "head_dim": 4, "state_dim": 2,
                                 "num_groups": 1, "chunk": 16}}
    # d_inner 8, H 2, P 4, N 2; S 20 -> chunk min(16, 32) = 16:
    # 2 chunks of 16 rows, triangle 136
    flops, nbytes = work.ssd_call(cfg, 20)
    per_chunk = 1 * 2 * 136 * 2 + 2 * (2 * 136 * 4 + 4 * 16 * 2 * 4)
    assert flops == 2 * per_chunk
    assert nbytes == 2 * (2 * 2 * 20 * 4 + 2 * 20 + 2 * 1 * 20 * 2) + 4 * 2


def test_least_time_is_the_larger_bound():
    assert peaks.least_time(989e12, 0) == pytest.approx(1.0)
    assert peaks.least_time(0, 3.35e12) == pytest.approx(1.0)


def test_model_flops_hand_count():
    # per layer: attention 8*8 + 2*8*4 + 8*8 = 192, MoE router 24 + 2 experts
    # x 3 x 40 = 264; 2 layers: 912 parameters
    assert work.active_params(TINY) == 2 * (192 + 24 + 240)
    S = 3
    want = 2 * 912 * S + 2 * 8 * 10 + 2 * (4 * 2 * 4 * 6)
    assert work.model_flops(TINY, S) == want


@pytest.mark.parametrize("config", ["jamba_v01_16L", "mixtral_8x7b_16L"])
def test_active_params_match_the_port_count(config):
    """The benchmark's count of the weights a token passes through equals
    the port's ``active_param_count`` less the embedding, the head, the
    norm scales and the per-head SSM scalars."""
    conf = spec.part("configs", config)
    cfg = spec.port_config(conf)
    D = cfg.d_model
    rest = 2 * cfg.vocab_size * D + (2 * cfg.num_layers + 1) * D
    if cfg.ssm is not None:
        n_mamba = sum(1 for m, _ in work.layer_kinds(conf) if m == "mamba")
        rest += n_mamba * 3 * cfg.ssm.num_heads(D)
    assert work.active_params(conf) == cfg.active_param_count() - rest


def test_jamba_mfu_flops_at_4096():
    """One period of 8 layers at 4,096 tokens is ~23.4 TFLOP (2 x 11.7
    B weights a token passes through x 4,096, plus attention's and the
    head's); the configuration holds two periods."""
    conf = spec.part("configs", "jamba_v01_16L")
    assert work.model_flops({**conf, "num_layers": 8}, 4096) == \
        pytest.approx(23.4e12, rel=0.015)
    assert work.model_flops(conf, 4096) == pytest.approx(2 * 23.4e12,
                                                         rel=0.015)
    calls = work.step_calls(conf, 4096)
    assert (len(calls["gmm"]), len(calls["flash"]), len(calls["ssd"])) == \
        (24, 2, 14)
