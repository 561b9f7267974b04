"""The port's mesh front door (counterpart of ``repro.mesh``).

* :class:`MeshConfig` — one configuration (``to_net()`` gives the numpy
  oracle's ``NetConfig``, ``to_sim()`` the port's ``SimConfig``);
* :class:`Topology` — mesh / torus / ring-mesh / multi-chip;
* :class:`Endpoint` — the per-tile attach protocol (the valid/ready
  forward link ``offer``, the credit-counted reverse link ``deliver``),
  with the built-ins :class:`ProgramEndpoint`, :class:`DmaEndpoint` and
  :class:`MemoryControllerEndpoint`, and :func:`trace_to_program`;
* :class:`Simulator` — the facade (``attach`` / ``run`` /
  ``run_until_drained`` / ``telemetry()``) over its :data:`BACKENDS`:
  ``torch`` (the default; on the card unless ``device="cpu"``) and the
  ``numpy`` oracle;
* :class:`Telemetry` — the normalized telemetry record;
* the traffic-pattern library (``make_traffic`` and friends).
"""
from . import encoding  # noqa: F401
from .config import MeshConfig  # noqa: F401
from .encoding import validate_program  # noqa: F401
from .endpoint import (DmaEndpoint, Endpoint,  # noqa: F401
                       MemoryControllerEndpoint, ProgramEndpoint, Request,
                       Response, trace_to_program)
from .simulator import BACKENDS, Simulator  # noqa: F401
from .telemetry import (PORT_NAMES, TELEMETRY_ARRAY_FIELDS,  # noqa: F401
                        Telemetry, render_heatmap)
from .topology import Topology  # noqa: F401
from .traffic import (PATTERNS, PROG_KEYS, bit_complement,  # noqa: F401
                      empty_program, hotspot, make_traffic,
                      nearest_neighbor, tornado, transpose, uniform_random)

__all__ = ["MeshConfig", "Topology", "Simulator", "BACKENDS", "Telemetry",
           "encoding", "validate_program", "PORT_NAMES", "render_heatmap",
           "TELEMETRY_ARRAY_FIELDS", "Endpoint", "Request", "Response",
           "ProgramEndpoint", "DmaEndpoint", "MemoryControllerEndpoint",
           "trace_to_program", "PATTERNS", "PROG_KEYS",
           "empty_program", "make_traffic", "uniform_random", "transpose",
           "bit_complement", "tornado", "hotspot", "nearest_neighbor"]
