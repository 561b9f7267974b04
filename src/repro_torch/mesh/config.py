"""One mesh configuration for the port.

The port's own copy of ``repro/mesh/config.py``'s ``MeshConfig``
(``tests/test_torch_mesh.py`` holds its validation equal to the
original's).  It converts losslessly to and from the numpy oracle's
:class:`repro_torch.core.netsim.NetConfig` (:meth:`MeshConfig.to_net`,
:meth:`MeshConfig.from_net`) and to the port's
:class:`repro_torch.netsim.sim.SimConfig` (:meth:`MeshConfig.to_sim`),
which has no ``record_log`` (a per-response Python log cannot live in the
device state): ``MeshConfig -> SimConfig -> MeshConfig`` resets it to
``False``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.netsim import NetConfig
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
    record_log: bool = False      # numpy oracle only; dropped by to_sim()
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

    # -- NetConfig (the numpy oracle) ----------------------------------
    @classmethod
    def from_net(cls, cfg: NetConfig) -> "MeshConfig":
        return cls(nx=cfg.nx, ny=cfg.ny, router_fifo=cfg.router_fifo,
                   ep_fifo=cfg.ep_fifo, max_out_credits=cfg.max_out_credits,
                   mem_words=cfg.mem_words, resp_latency=cfg.resp_latency,
                   record_log=cfg.record_log, topology=cfg.topology)

    def to_net(self) -> NetConfig:
        return NetConfig(nx=self.nx, ny=self.ny, router_fifo=self.router_fifo,
                         ep_fifo=self.ep_fifo,
                         max_out_credits=self.max_out_credits,
                         mem_words=self.mem_words,
                         resp_latency=self.resp_latency,
                         record_log=self.record_log, topology=self.topology)

    # -- SimConfig (the port's simulator) --------------------------------
    @classmethod
    def from_sim(cls, cfg) -> "MeshConfig":
        """From a :class:`repro_torch.netsim.sim.SimConfig` (duck-typed)."""
        return cls(nx=cfg.nx, ny=cfg.ny, router_fifo=cfg.router_fifo,
                   ep_fifo=cfg.ep_fifo, max_out_credits=cfg.max_out_credits,
                   mem_words=cfg.mem_words, resp_latency=cfg.resp_latency,
                   topology=getattr(cfg, "topology", None))

    def to_sim(self):
        """To :class:`repro_torch.netsim.sim.SimConfig` (drops
        ``record_log``)."""
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
        """Accept a :class:`MeshConfig`, a ``NetConfig`` or anything with
        ``SimConfig``'s fields and return the equivalent
        :class:`MeshConfig`."""
        if isinstance(cfg, cls):
            return cfg
        if isinstance(cfg, NetConfig):
            return cls.from_net(cfg)
        if all(hasattr(cfg, f) for f in
               ("nx", "ny", "router_fifo", "ep_fifo", "max_out_credits",
                "mem_words", "resp_latency")):
            return cls.from_sim(cfg)
        raise TypeError(
            f"cannot interpret {type(cfg).__name__} as a mesh configuration; "
            "pass a MeshConfig, NetConfig or SimConfig")

    def replace(self, **kw) -> "MeshConfig":
        return dataclasses.replace(self, **kw)

    # -- stable identity (result-cache keys, JSON artifacts) -------------
    def cache_token(self) -> str:
        """A stable, human-readable string identifying this configuration,
        the mesh half of a design-space sweep's result-cache key
        (``record_log`` is left out: it changes what is logged, never what
        is simulated)."""
        return (f"{self.nx}x{self.ny}/{self.topology.spec}"
                f"/fifo{self.router_fifo}/ep{self.ep_fifo}"
                f"/cred{self.max_out_credits}/mem{self.mem_words}"
                f"/lat{self.resp_latency}")
