"""Plain fp32 references of the benchmark's model families: plain
``torch`` operations, no kernel, cache or batching, and nothing of the
program under test.  Each family's module has ``last_logits(cfg, params,
tokens, linear, stats, rule)``: the fp32 logits of the last position of
one prompt, then those of its other paths under ``rule``
(``common.py``)."""
