"""Lumos-style area/energy cost model for the router design space.

The BaseJump paper's sizing argument is that mesh routers must stay
*small* — the network is amortized across hundreds of tiles, so every
extra FIFO slot is paid ``nx * ny`` times.  This module prices exactly
the two quantities the DSE trades off:

* **Buffer area** — the router's input FIFOs dominate its storage; a
  tile holds ``networks x ports x fifo_depth`` router flit slots (the
  fwd/rev physical networks of the paper's two-network datapath, five
  ports each) plus the endpoint's ``ep_fifo`` slots, each
  :data:`FLIT_BITS` wide (the packed 5-lane int32 packet).  Area is
  flits x bits x an SRAM cell-area constant — the same
  budget-constrained accounting lumos's MPSoC model applies to core
  area (``SNIPPETS.md``), reduced to the network's share.
* **Link energy** — every W/E/N/S crossing moves one flit over one mesh
  channel; :class:`~repro_torch.netsim.measure.PhaseStats.hops` counts
  them during the measurement window, and energy is
  ``hops x flit_bits x pJ/bit/hop``.

The constants are deliberately plain dataclass knobs (45 nm-flavored
defaults in the lumos tech-node spirit), not a process model: the DSE
compares configurations under ONE consistent model, and the frontier
shape — not the absolute mm² — is the result.  Swap the knobs to re-cost
a sweep without re-simulating: the result cache stores raw telemetry and
the cost model is applied at frontier-extraction time.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.netsim import NUM_DIRS
from repro_torch.mesh.config import MeshConfig

__all__ = ["FLIT_BITS", "CostModel"]

# the packed packet: 5 int32 lanes (hdr/addr/data/cmp/tag)
FLIT_BITS = 5 * 32


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Area/energy knobs (hashable; JSON-ready via :meth:`to_json`).

    ``sram_um2_per_bit`` ~ a 6T SRAM cell at a 45 nm-class node;
    ``link_pj_per_bit_hop`` ~ on-chip wire + router traversal energy per
    bit per hop.  ``networks`` is the paper's fwd/rev physical-network
    pair; ``ports`` the 5-port (P/W/E/N/S) router.
    """
    flit_bits: int = FLIT_BITS
    sram_um2_per_bit: float = 0.525
    link_pj_per_bit_hop: float = 0.052
    networks: int = 2
    ports: int = NUM_DIRS

    # -- area -----------------------------------------------------------
    def tile_buffer_bits(self, fifo_depth: int, ep_fifo: int = 4) -> int:
        """Router + endpoint FIFO storage of one tile, in bits."""
        flits = self.networks * self.ports * int(fifo_depth) + int(ep_fifo)
        return flits * self.flit_bits

    def buffer_area_mm2(self, cfg: MeshConfig) -> float:
        """Total mesh buffer area (mm²) of a configuration — the x-axis
        of the Pareto frontier."""
        bits = self.tile_buffer_bits(cfg.router_fifo, cfg.ep_fifo)
        return cfg.nx * cfg.ny * bits * self.sram_um2_per_bit * 1e-6

    # -- energy ---------------------------------------------------------
    def hop_energy_pj(self, hops: float) -> float:
        """Energy (pJ) of ``hops`` flit link-crossings (both networks)."""
        return float(hops) * self.flit_bits * self.link_pj_per_bit_hop

    def energy_per_packet_pj(self, hops: float, packets: float) -> float:
        """Average network energy per delivered packet during a
        measurement window (0 when nothing was delivered)."""
        return self.hop_energy_pj(hops) / packets if packets > 0 else 0.0

    def to_json(self) -> Dict[str, float]:
        return dataclasses.asdict(self)
