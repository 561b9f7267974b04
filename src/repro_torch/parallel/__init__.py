"""SPMD over ``torch.distributed``: the named mesh and its collectives
(:mod:`.comm`) and the logical-axis sharding rules (:mod:`.sharding`)
(the port's counterpart of ``repro.parallel``; its pipeline schedule is
the SPMD training slice's)."""
