"""One mesh configuration for the port.

The port's own copy of ``repro/mesh/config.py``'s ``MeshConfig``
(``tests/test_torch_mesh.py`` holds its validation equal to the
original's).  :meth:`MeshConfig.to_sim` returns the port's
:class:`repro_torch.netsim.sim.SimConfig`.  The conversions to and from
the numpy oracle's ``NetConfig`` (and its ``record_log`` field) come with
the oracle, which the port does not have yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.mesh.topology import Topology

__all__ = ["MeshConfig"]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh description (frozen and hashable).

    Field names follow the paper's parameters: ``router_fifo`` is the
    per-direction input-FIFO depth, ``ep_fifo`` is the standard endpoint's
    ``fifo_els_p``, ``max_out_credits`` is ``max_out_credits_p``.
    """
    nx: int
    ny: int
    router_fifo: int = 4
    ep_fifo: int = 4
    max_out_credits: int = 16
    mem_words: int = 64
    resp_latency: int = 1
    # network topology (mesh / torus / ring_mesh / multi_chip); None is
    # normalized to the plain mesh
    topology: Optional[Topology] = None

    def __post_init__(self):
        if self.nx < 1 or self.ny < 1:
            raise ValueError(
                f"mesh dimensions must be positive, got nx={self.nx}, "
                f"ny={self.ny}")
        if self.topology is None:
            object.__setattr__(self, "topology", Topology.mesh())
        self.topology.validate_for(self.nx, self.ny)

    # -- SimConfig (the port's simulator) --------------------------------
    @classmethod
    def from_sim(cls, cfg) -> "MeshConfig":
        """From a :class:`repro_torch.netsim.sim.SimConfig` (duck-typed)."""
        return cls(nx=cfg.nx, ny=cfg.ny, router_fifo=cfg.router_fifo,
                   ep_fifo=cfg.ep_fifo, max_out_credits=cfg.max_out_credits,
                   mem_words=cfg.mem_words, resp_latency=cfg.resp_latency,
                   topology=getattr(cfg, "topology", None))

    def to_sim(self):
        """To :class:`repro_torch.netsim.sim.SimConfig`."""
        from repro_torch.netsim.sim import SimConfig
        return SimConfig(nx=self.nx, ny=self.ny, router_fifo=self.router_fifo,
                         ep_fifo=self.ep_fifo,
                         max_out_credits=self.max_out_credits,
                         mem_words=self.mem_words,
                         resp_latency=self.resp_latency,
                         topology=self.topology)

    # -- normalization -------------------------------------------------
    @classmethod
    def coerce(cls, cfg) -> "MeshConfig":
        """Accept a :class:`MeshConfig` or anything with ``SimConfig``'s
        fields and return the equivalent :class:`MeshConfig`."""
        if isinstance(cfg, cls):
            return cfg
        if all(hasattr(cfg, f) for f in
               ("nx", "ny", "router_fifo", "ep_fifo", "max_out_credits",
                "mem_words", "resp_latency")):
            return cls.from_sim(cfg)
        raise TypeError(
            f"cannot interpret {type(cfg).__name__} as a mesh configuration; "
            "pass a MeshConfig or SimConfig")

    def replace(self, **kw) -> "MeshConfig":
        return dataclasses.replace(self, **kw)
