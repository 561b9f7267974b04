"""Hand-written Hopper kernels of the port and what surrounds them.

* :mod:`.backend` — which device an entry point runs on (Hopper or the
  CPU; never a silent fallback);
* :mod:`.build` — ``nvcc`` builds of ``csrc/*.cu`` into ``build/kernels/``,
  bound with ``ctypes``;
* :mod:`.router_step` — the mesh router cycle (``csrc/router_step.cu``),
  its plain PyTorch version and its launch counter.  Import it as
  ``repro_torch.kernels.router_step``; it depends on
  :mod:`repro_torch.netsim.sim`, which imports :mod:`.backend` from here;
* :mod:`.flash_attention`, :mod:`.ssd_scan`, :mod:`.moe_gmm` — the model
  kernels (``csrc/flash_attention.cu``, ``csrc/ssd_scan.cu``,
  ``csrc/moe_gmm.cu``), each with its launch counter; :mod:`.ref` holds
  their plain versions and :mod:`.ops` the wrappers at the models'
  layouts; :mod:`.record` the records of their calls on ``meta`` (the
  costing tools' dry run) and on the CPU.  ``flash_attention_op``,
  ``ssd_scan_op`` and ``grouped_matmul`` are exported from here, but no
  kernel module is imported until one of them is first asked for.
"""
import importlib

from . import backend, build  # noqa: F401

__all__ = ["backend", "build", "flash_attention_op", "ssd_scan_op",
           "grouped_matmul"]

_LAZY = {"flash_attention_op": "ops", "ssd_scan_op": "ops",
         "grouped_matmul": "ops"}


def __getattr__(name):
    if name in _LAZY:
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                       name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
