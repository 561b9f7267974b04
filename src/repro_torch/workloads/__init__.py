"""Workload traffic compiler: the model stack's communication patterns,
lowered to mesh injection programs (the port of ``repro.workloads``).

The model stack describes communication — ring all-reduces over sharded
parameters, MoE token all-to-alls, pipeline activation hand-offs, PGAS
scatter/gathers.  This package compiles those patterns into the
injection-program schema both facade backends consume.  The compilers
are copies of the JAX package's; the model-stack files their docstrings
name (``parallel/sharding.py``, ``models/moe.py``, ...) are the JAX
package's, whose traffic they model.

* :mod:`.placement` — rank → tile maps (:class:`Placement`, snake rings);
* :mod:`.collectives` — :func:`ring_all_reduce`,
  :func:`parameter_broadcast`;
* :mod:`.moe` — :func:`moe_all_to_all` with a tunable hot-expert skew;
* :mod:`.pipeline` — :func:`pipeline_p2p` microbatch schedules;
* :mod:`.pgas` — :func:`pgas_from_batches` lowering PacketBatch-shaped
  arrays to programs, plus :func:`expected_memory` for end-state checks;
* :mod:`.runner` — :func:`run_workload` through the
  :class:`repro_torch.mesh.Simulator` facade on the card (``"torch"``),
  the numpy oracle, or ``"both"`` with a bit-identical parity check,
  producing :class:`WorkloadReport`\\ s;
* :mod:`.congestion` — :class:`CongestionModel` fit from reports.
"""
from .base import Packet, Workload, merge_workloads, program_from_packets
from .collectives import parameter_broadcast, ring_all_reduce
from .congestion import OP_FAMILY, WORD_BYTES, CongestionModel, calibrate
from .moe import expert_capacity, moe_all_to_all
from .pgas import expected_memory, pgas_from_batches, pgas_scatter
from .pipeline import pipeline_p2p
from .placement import Placement, row_major_order, snake_order
from .runner import WorkloadReport, default_workload_config, run_workload

__all__ = [
    "Packet", "Workload", "merge_workloads", "program_from_packets",
    "ring_all_reduce", "parameter_broadcast",
    "moe_all_to_all", "expert_capacity",
    "pipeline_p2p",
    "pgas_from_batches", "pgas_scatter", "expected_memory",
    "Placement", "snake_order", "row_major_order",
    "WorkloadReport", "run_workload", "default_workload_config",
    "CongestionModel", "calibrate", "OP_FAMILY", "WORD_BYTES",
]
