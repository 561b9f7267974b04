"""Design-space exploration over the mesh simulator (the port of
``repro.dse``).

Declare a sweep (:class:`SweepSpec`), run it (:func:`run_sweep` —
bucketed by batched shape, each bucket's points the lanes of one batched
run on the card through the router kernel, fanned out over cards,
resumable from the on-disk :class:`ResultCache`) and extract Pareto
frontiers of buffer area vs. saturation throughput
(:func:`frontier_artifact` / :func:`pareto_front`) priced by the
lumos-style :class:`CostModel`.

    from repro_torch.dse import SweepSpec, run_sweep, frontier_artifact
    spec = SweepSpec(nx=16, ny=16, topologies=("mesh", "torus"))
    result = run_sweep(spec, cache_dir="dse_cache")    # on the card
    artifact = frontier_artifact(result)
"""
from .cache import ResultCache, config_hash
from .cost import FLIT_BITS, CostModel
from .pareto import ascii_frontier, frontier_is_monotone, pareto_front
from .runner import (SweepResult, frontier_artifact, frontier_ascii,
                     run_sweep, write_frontier)
from .spec import (WORKLOAD_FAMILIES, SweepPoint, SweepSpec,
                   workload_entries, workload_instance)

__all__ = [
    "SweepSpec", "SweepPoint", "WORKLOAD_FAMILIES", "workload_entries",
    "workload_instance", "run_sweep", "SweepResult",
    "frontier_artifact", "frontier_ascii", "write_frontier",
    "CostModel", "FLIT_BITS",
    "pareto_front", "frontier_is_monotone", "ascii_frontier",
    "ResultCache", "config_hash",
]
