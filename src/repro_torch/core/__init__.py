"""The paper's primary contribution on a mesh of ranks (the port's
counterpart of ``repro.core``), and the network constants.

* :mod:`.coords`      — PGAS ``<X, Y, local>`` addressing (C1)
* :mod:`.routing`     — XY dimension-ordered collectives (C4)
* :mod:`.pgas`        — remote store / load / CAS (C1)
* :mod:`.credits`     — credit flow control and fences (C3)
* :mod:`.token_queue` — credit-bounded channels (C6)
* :mod:`.endpoint`    — the standard endpoint (C5)
* :mod:`.sync`        — barrier and mutex on remote CAS (C8)
* :mod:`.netsim`      — the network constants and the numpy oracle

The collectives run inside ranks over ``torch.distributed`` process
groups (``repro_torch.parallel.comm``), where the reference's run inside
``shard_map``.
"""
