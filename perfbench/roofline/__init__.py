"""The benchmark's own arithmetic of work: the H100's published peaks
(:mod:`.peaks`) and the operations and bytes of each kernel's call and of
a whole prefill step, from shapes alone (:mod:`.work`).  Frozen here so
that a change to the program cannot move its own yardstick."""
