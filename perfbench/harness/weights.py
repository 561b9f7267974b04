"""Random weights drawn on the device from the seed, one call per
parameter, in the dtype each is served in.  The names, shapes and dtypes
are the port's (its model class's ``param_table`` and ``param_dtype``);
the values follow its initialisation rules by name: norm scales and the
SSM's ``D_skip`` ones, ``A_log`` the log of 1..16 over the heads,
biases zero, the embedding N(0, 1), every other weight N(0, 1/fan_in)
with fan_in its second-last dimension, and the projections that write
into the residual stream (attention's ``wo``, the mixer's ``out_proj``,
the MLPs' and experts' down projections) scaled by 1/sqrt(2 x layers).

The embedding's rows have RMS 1, as the RMSNorm that reads them outputs,
and the residual writes are scaled as GPT-2 and Megatron-LM initialise
them: the residual stream then carries each token's own signal through
every layer and a rounding error is not amplified layer by layer, as in
a trained model; each router spreads the tokens over its experts.  Drawn
at 1/sqrt(vocab), the embedding is swamped by the first mixer's output,
which averages over the context: late positions look alike and every
router sends them to the same experts, most assignments dropped at
capacity.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

RESIDUAL_WRITES = ("wo", "out_proj", "w_down", "moe_down")


def _value(name: str, shape: Tuple[int, ...], dtype, g, device,
           layers: int):
    if "norm" in name or name.endswith("D_skip"):
        return torch.ones(shape, dtype=dtype, device=device)
    if name.endswith("A_log"):
        a = torch.linspace(1.0, 16.0, shape[-1], device=device).log()
        return a.expand(shape).to(dtype).contiguous()
    if name.endswith(("dt_bias", "conv_b")) or "/b" in name:
        return torch.zeros(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=g, dtype=dtype, device=device)
    if name == "embed":
        return w
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = fan_in ** -0.5
    if name.endswith(RESIDUAL_WRITES):
        std /= (2 * layers) ** 0.5
    return w.mul_(std)


def draw(table: Dict[str, Tuple[int, ...]], dtype_of, seed: int,
         device, layers: int) -> Dict[str, torch.Tensor]:
    """{name: tensor} for every row of ``table``, ``dtype_of(name)``
    giving each dtype, for a model of ``layers`` layers."""
    g = torch.Generator(device=device).manual_seed(seed)
    return {name: _value(name, tuple(shape), dtype_of(name), g, device,
                         layers)
            for name, shape in sorted(table.items())}
