"""SPMD over ``torch.distributed``: the named mesh and its collectives,
each with its backward (:mod:`.comm`), and the logical-axis sharding rules
(:mod:`.sharding`) (the port's counterpart of ``repro.parallel``).  The
reference's pipeline schedule (``parallel/pipeline.py``) waits for ROADMAP
item 13b-2."""
