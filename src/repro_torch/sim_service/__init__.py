"""Simulation-as-a-service: the continuously batched, streaming front
end over the port's mesh simulator (counterpart of ``repro.sim_service``).

Concurrent phased-measurement requests (:class:`SimRequest`) and
saturation-curve sweeps (:class:`SweepRequest`) are queued, bucketed by
batched shape (:class:`~repro_torch.netsim.measure.SweepKey` + padded
program length + streaming cadence), run as ONE batched call per bucket
per tick — on a card one router kernel call per fence block — and
streamed back per fence block, with every :class:`PhaseStats` field
equal to a direct :func:`repro_torch.netsim.measure.phased_stats` run of
the request alone (``tests/test_torch_service.py`` holds the service to
``repro.sim_service``).

Entry points, on the card unless ``device="cpu"``:

* :class:`SimService` — synchronous facade (``run`` / ``run_one`` /
  ``stream``);
* :class:`SimServer` — the async server (``submit`` + a ``serve()``
  task; consume ``Ticket.stream()`` / ``Ticket.result()``);
* ``compile_cache_dir=`` on either is the directory the router library
  is built into and loaded from, around that server's own work only, so
  a process-cold start on a built library runs no ``nvcc``.
"""
from .bucketing import BucketKey, bucket_key, next_pow2  # noqa: F401
from .metrics import ServiceMetrics  # noqa: F401
from .request import (LaneSpec, ServiceOverloaded, SimRequest,  # noqa: F401
                      SimResponse, SweepRequest, SweepResponse)
from .server import (SimServer, SimService, TelemetryChunk,  # noqa: F401
                     Ticket)
from .streaming import (BatchRunner, clear_service_cache,  # noqa: F401
                        executed_shapes)

__all__ = ["SimRequest", "SweepRequest", "SimResponse", "SweepResponse",
           "LaneSpec", "ServiceOverloaded", "BucketKey", "bucket_key",
           "next_pow2", "ServiceMetrics", "SimServer", "SimService",
           "TelemetryChunk", "Ticket", "BatchRunner",
           "clear_service_cache", "executed_shapes"]
