"""Constants of the mesh network model.

A copy of the constants at the top of the JAX package's
``repro/core/netsim.py`` (the port imports nothing from that package);
``tests/test_torch_mesh.py`` holds every value equal to its original.
The numpy oracle ``MeshSim`` that lives beside them there is not part of
the port yet.
"""
from __future__ import annotations

__all__ = ["P", "W", "E", "N", "S", "NUM_DIRS", "LAT_BINS", "NO_MEASURE",
           "OP_LOAD", "OP_STORE", "OP_CAS", "unloaded_rtt"]

# bsg_noc_pkg: typedef enum {P=0, W, E, N, S}
P, W, E, N, S = 0, 1, 2, 3, 4
NUM_DIRS = 5

# Telemetry: per-packet round-trip latency histogram resolution.  The last
# bin is an overflow bucket (latency >= LAT_BINS - 1 cycles).
LAT_BINS = 512
# Default measurement window = everything (any int32 tag qualifies).
NO_MEASURE = 2**31 - 1

OP_LOAD = 0   # ePacketOp_remote_load
OP_STORE = 1  # ePacketOp_remote_store
OP_CAS = 2    # ePacketOp_remote_swap_aq/_rl pair, modeled as one CAS


def unloaded_rtt(hops: int) -> int:
    """Analytic unloaded round-trip latency (cycles) at ``hops`` Manhattan
    distance: inject + hops + deliver-to-endpoint + yumi/service +
    response-inject + hops + deliver + registered output = ``2*hops + 5``.
    For 1 hop this is the paper's 7 cycles."""
    return 2 * hops + 5
