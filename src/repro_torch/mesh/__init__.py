"""The port's mesh front door (counterpart of ``repro.mesh``).

* :class:`MeshConfig` — one configuration (``to_sim()`` gives the port's
  ``SimConfig``);
* :class:`Topology` — mesh / torus / ring-mesh / multi-chip;
* :class:`Simulator` — the facade (``attach`` / ``run`` /
  ``run_until_drained`` / ``telemetry()``), on the card unless
  ``device="cpu"``;
* :class:`Telemetry` — the normalized telemetry record;
* the traffic-pattern library (``make_traffic`` and friends).
"""
from . import encoding  # noqa: F401
from .config import MeshConfig  # noqa: F401
from .encoding import validate_program  # noqa: F401
from .simulator import Simulator  # noqa: F401
from .telemetry import (PORT_NAMES, TELEMETRY_ARRAY_FIELDS,  # noqa: F401
                        Telemetry, render_heatmap)
from .topology import Topology  # noqa: F401
from .traffic import (PATTERNS, PROG_KEYS, bit_complement,  # noqa: F401
                      empty_program, hotspot, make_traffic,
                      nearest_neighbor, tornado, transpose, uniform_random)

__all__ = ["MeshConfig", "Topology", "Simulator", "Telemetry", "encoding",
           "validate_program", "PORT_NAMES", "render_heatmap",
           "TELEMETRY_ARRAY_FIELDS", "PATTERNS", "PROG_KEYS",
           "empty_program", "make_traffic", "uniform_random", "transpose",
           "bit_complement", "tornado", "hotspot", "nearest_neighbor"]
