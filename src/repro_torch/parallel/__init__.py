"""SPMD over ``torch.distributed``: the named mesh and its collectives,
each with its backward (:mod:`.comm`), the logical-axis sharding rules
(:mod:`.sharding`) and the token-queue pipeline schedule
(:mod:`.pipeline`) (the port's counterpart of ``repro.parallel``)."""
