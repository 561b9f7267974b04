"""The PyTorch/CUDA port of the BaseJump mesh network reproduction.

A package of its own beside the JAX reference ``repro``; it imports
``torch`` and numpy and nothing of JAX or of ``repro``.

* :mod:`repro_torch.mesh` — configuration, packed-header encoding,
  topologies, the traffic library, telemetry and the ``Simulator`` facade
  (counterpart of ``repro.mesh``);
* :mod:`repro_torch.netsim` — the cycle-level simulator with an explicit
  lane axis, its drivers, phased load–latency measurement (batched, and
  streamed fence block by fence block) and the state conversions from the
  JAX package (counterpart of ``repro.netsim_jax``);
* :mod:`repro_torch.workloads` — the model stack's traffic (ring
  all-reduce, broadcast, MoE all-to-all, pipeline, PGAS) compiled to
  injection programs, run to the drain fence through the facade, and the
  congestion model fit from the reports (counterpart of
  ``repro.workloads``);
* :mod:`repro_torch.dse` — design-space exploration: sweep specs, the
  bucketed runner whose buckets run as the lanes of one batched
  measurement through the router kernel, the result cache and the
  area/throughput Pareto frontiers (counterpart of ``repro.dse``);
* :mod:`repro_torch.sim_service` — the simulation service: phased
  measurements and saturation curves queued, bucketed by shape, run as
  one batched router call per bucket per tick and streamed per fence
  block (counterpart of ``repro.sim_service``);
* :mod:`repro_torch.kernels` — the device policy, the ``nvcc`` build and
  the Hopper kernels: the router step, flash attention, the SSD scan and
  the grouped matmul (counterpart of ``repro.kernels``);
* :mod:`repro_torch.configs` — the architecture configs;
* :mod:`repro_torch.models` — every model family (the Jamba hybrid, the
  dense/MoE/VLM transformer, the Mamba-2 LM, Whisper), each with its
  training ``loss`` (counterpart of ``repro.models``);
* :mod:`repro_torch.optim` — AdamW with an fp32 master copy (counterpart
  of ``repro.optim``);
* :mod:`repro_torch.data` — the deterministic synthetic data pipeline and
  its credit-bounded prefetcher (counterpart of ``repro.data``);
* :mod:`repro_torch.checkpoint` — atomic, crc-checked, async checkpoints
  in the reference's on-disk layout (counterpart of ``repro.checkpoint``);
* :mod:`repro_torch.runtime` — the fault-tolerant ``Trainer``
  (counterpart of ``repro.runtime``);
* :mod:`repro_torch.launch` — the train, prefill and serve steps and
  ``cell_rules``, the training launcher, the continuous-batching
  ``Server`` (on one card or on a mesh) and the meshes and rank launcher
  (counterpart of ``repro.launch``);
* :mod:`repro_torch.parallel` — the named mesh of process groups and its
  collectives, and the sharding rules (counterpart of ``repro.parallel``);
* :mod:`repro_torch.core` — the paper's SPMD mechanisms (PGAS addressing,
  XY collectives, credits, remote store / load / CAS, token queues, the
  endpoint, barrier and mutex), the network constants and the oracle;
* :mod:`repro_torch.obs` — the program's spans and counters, on while a
  profiler records.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
__all__ = ["checkpoint", "configs", "core", "data", "dse", "kernels",
           "launch", "mesh", "models", "netsim", "obs", "optim",
           "parallel", "runtime", "sim_service", "workloads"]
