"""Tiny stand-ins of a cell's files for runs on the CPU."""
import copy

from perfbench.harness import spec

SIZES = {"num_layers": 4, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
         "head_dim": 16, "d_ff": 128, "vocab_size": 256, "attn_period": 2,
         "moe": {"num_experts": 4, "top_k": 2, "d_ff_expert": 32,
                 "every_n_layers": 2, "capacity_factor": 1.25,
                 "router_jitter": 0.0},
         "ssm": {"state_dim": 16, "head_dim": 16, "expand": 2,
                 "num_groups": 1, "conv_width": 4, "chunk": 16},
         "dtype": "float32"}
LENGTHS = {"logspace": [16, 100, 4], "multiple_of": 4}


def conf(config: str, **over):
    """The configuration file ``config`` at tiny sizes."""
    c = {**spec.part("configs", config), **copy.deepcopy(SIZES), **over}
    if c["family"] == "moe":
        c["moe"]["every_n_layers"], c["d_ff"] = 1, 0
    return c


def traffic(name: str):
    return {**spec.part("traffic", name), "lengths": LENGTHS}
