"""Hand-written Hopper kernels of the port and what surrounds them.

* :mod:`.backend` — which device an entry point runs on (Hopper or the
  CPU; never a silent fallback);
* :mod:`.build` — ``nvcc`` builds of ``csrc/*.cu`` into ``build/kernels/``,
  bound with ``ctypes``;
* :mod:`.router_step` — the mesh router cycle (``csrc/router_step.cu``),
  its plain PyTorch version and its launch counter.  Import it as
  ``repro_torch.kernels.router_step``; it depends on
  :mod:`repro_torch.netsim.sim`, which imports :mod:`.backend` from here.
"""
from . import backend, build  # noqa: F401

__all__ = ["backend", "build"]
