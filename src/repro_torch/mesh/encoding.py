"""Packed-header packet encoding shared by the whole netsim stack.

The paper's mesh moves *narrow* packets: two destination coordinates,
two source coordinates and a 2-bit opcode, next to the address/data
payload.  The JAX simulator exploits that by bit-packing all five
routing/control fields into a single int32 **header word**, so a packet
occupies 5 int32 lanes (``hdr, addr, data, cmp, tag``) instead of 9 —
nearly halving the per-cycle router-FIFO traffic and the emitted HLO.

Header layout (LSB first)::

    bits  0..6   dst_x      (COORD_BITS = 7 -> meshes up to 128x128)
    bits  7..13  dst_y
    bits 14..20  src_x
    bits 21..27  src_y
    bits 28..29  op         (OP_BITS = 2 -> the 3 remote ops + 1 spare)

The packed value is < 2**30, so it is always a *non-negative* int32 and
never wraps.  ``addr``/``data``/``cmp``/``tag`` stay full int32 lanes —
negative payload data passes through unchanged (asserted in
``tests/test_encoding.py``).

Everything here is plain integer arithmetic (``&``, ``|``, shifts), so
the same helpers work on Python ints, numpy arrays and torch tensors.

This is the port's own copy of ``repro/mesh/encoding.py`` (the port
imports nothing from the JAX package); ``tests/test_torch_mesh.py`` holds
it equal to the original.  Shared by:

* :func:`repro_torch.netsim.sim.load_program` — packs injection programs
  and validates the packet domain (:func:`validate_program`);
* :class:`repro_torch.mesh.Simulator` — validates programs on ``attach``;
* :func:`repro_torch.netsim.sim.step_core` and the CUDA router kernel —
  the kernel repeats the same shifts and masks in C++.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

__all__ = ["COORD_BITS", "COORD_LIMIT", "COORD_MASK", "OP_BITS", "OP_LIMIT",
           "OP_MASK", "DST_X_SHIFT", "DST_Y_SHIFT", "SRC_X_SHIFT",
           "SRC_Y_SHIFT", "OP_SHIFT", "HEADER_FIELDS", "pack_header",
           "pack_dst_op", "with_src", "swap_for_response", "hdr_dst_x",
           "hdr_dst_y", "hdr_src_x", "hdr_src_y", "hdr_op", "decode_header",
           "chip_split", "chip_join", "validate_program"]

COORD_BITS = 7
COORD_LIMIT = 1 << COORD_BITS          # 128: max mesh extent per dimension
COORD_MASK = COORD_LIMIT - 1
OP_BITS = 2
OP_LIMIT = 1 << OP_BITS                # 4 opcodes
OP_MASK = OP_LIMIT - 1

DST_X_SHIFT = 0
DST_Y_SHIFT = COORD_BITS
SRC_X_SHIFT = 2 * COORD_BITS
SRC_Y_SHIFT = 3 * COORD_BITS
OP_SHIFT = 4 * COORD_BITS

# mask covering the (dst_x, dst_y) pair — also the width of the (src_x,
# src_y) pair, which sits exactly SRC_X_SHIFT bits higher
_PAIR_MASK = (1 << (2 * COORD_BITS)) - 1

HEADER_FIELDS = ("dst_x", "dst_y", "src_x", "src_y", "op")


def pack_header(dst_x, dst_y, src_x, src_y, op):
    """Pack the five header fields into one word.  Inputs are masked to
    their field widths, so packing is total; use :func:`validate_program`
    to *reject* out-of-range values instead of silently wrapping them."""
    return ((dst_x & COORD_MASK)
            | ((dst_y & COORD_MASK) << DST_Y_SHIFT)
            | ((src_x & COORD_MASK) << SRC_X_SHIFT)
            | ((src_y & COORD_MASK) << SRC_Y_SHIFT)
            | ((op & OP_MASK) << OP_SHIFT))


def pack_dst_op(dst_x, dst_y, op):
    """Header with the source pair left zero — the form injection
    *programs* are stored in (the source is the injecting tile, ORed in
    by :func:`with_src` at injection time)."""
    return ((dst_x & COORD_MASK)
            | ((dst_y & COORD_MASK) << DST_Y_SHIFT)
            | ((op & OP_MASK) << OP_SHIFT))


def with_src(hdr, src_x, src_y):
    """OR the source pair into a header whose src field is zero."""
    return hdr | (((src_x & COORD_MASK)
                   | ((src_y & COORD_MASK) << COORD_BITS)) << SRC_X_SHIFT)


def swap_for_response(hdr, src_x, src_y):
    """The endpoint's reply header: the request's source pair becomes the
    destination (so the packet routes home), ``(src_x, src_y)`` — the
    servicing tile — becomes the source, and the opcode is preserved."""
    return (((hdr >> SRC_X_SHIFT) & _PAIR_MASK)
            | (((src_x & COORD_MASK)
                | ((src_y & COORD_MASK) << COORD_BITS)) << SRC_X_SHIFT)
            | (hdr & (OP_MASK << OP_SHIFT)))


def hdr_dst_x(hdr):
    return (hdr >> DST_X_SHIFT) & COORD_MASK


def hdr_dst_y(hdr):
    return (hdr >> DST_Y_SHIFT) & COORD_MASK


def hdr_src_x(hdr):
    return (hdr >> SRC_X_SHIFT) & COORD_MASK


def hdr_src_y(hdr):
    return (hdr >> SRC_Y_SHIFT) & COORD_MASK


def hdr_op(hdr):
    return (hdr >> OP_SHIFT) & OP_MASK


def decode_header(hdr) -> Dict[str, np.ndarray]:
    """The five header fields of ``hdr`` (scalar or array), as a dict."""
    return {"dst_x": hdr_dst_x(hdr), "dst_y": hdr_dst_y(hdr),
            "src_x": hdr_src_x(hdr), "src_y": hdr_src_y(hdr),
            "op": hdr_op(hdr)}


_I32 = np.iinfo(np.int32)


# ----------------------------------------------------------------------
# multi-chip coordinates
# ----------------------------------------------------------------------
# On a multi-chip topology (repro_torch.mesh.topology.Topology.multi_chip) the
# global x coordinate *contains* the chip id: chip boundaries fall on
# multiples of the chip width, so x = chip * width + local_x.  The packed
# header needs no extra bits — BSG Ten's scheme, where the off-chip hop
# is address-transparent.  These helpers make the containment explicit
# (and testable): split/join are exact inverses for every representable
# coordinate, so the chip-id "bits" round-trip through the header.

def chip_split(x, topology, nx: int):
    """``(chip_id, local_x)`` of a global x coordinate under a multi-chip
    ``topology`` on an ``nx``-wide array.  Elementwise (ints or arrays)."""
    w = topology.chip_width(nx)
    return x // w, x % w


def chip_join(chip, local_x, topology, nx: int):
    """Global x coordinate of ``(chip_id, local_x)`` — the exact inverse
    of :func:`chip_split`."""
    return chip * topology.chip_width(nx) + local_x


def validate_program(entries: Dict[str, np.ndarray],
                     nx: Optional[int] = None,
                     ny: Optional[int] = None,
                     topology=None) -> None:
    """Reject injection programs whose packets cannot be represented.

    For every non-padding entry (``op >= 0``):

    * ``dst_x`` / ``dst_y`` must fit the packed ``COORD_BITS``-bit
      coordinate fields — and lie inside the mesh when ``nx``/``ny`` are
      given (the facade attach path passes them; a packet aimed off-mesh
      can never be delivered and wedges the router it reaches);
    * ``op`` must fit the ``OP_BITS``-bit opcode field;
    * ``addr`` / ``data`` / ``cmp`` / ``not_before`` must fit int32 (the
      simulator's lane width, the same limit the JAX package applies so
      programs stay portable between the two).

    When ``topology`` is given it is checked against the array shape
    (:meth:`repro_torch.mesh.topology.Topology.validate_for` — e.g. multi-chip
    needs ``nx`` divisible into equal-width chips).  Destination
    coordinates themselves are topology-independent: they are global
    (the chip id is contained in the x coordinate, see
    :func:`chip_split`), so the same bounds apply on every topology.

    Raises ``ValueError`` naming the offending field and its bound.
    """
    if topology is not None and nx is not None and ny is not None:
        topology.validate_for(nx, ny)
    op = np.asarray(entries["op"])
    live = op >= 0
    bounds = {
        "dst_x": COORD_LIMIT if nx is None else min(nx, COORD_LIMIT),
        "dst_y": COORD_LIMIT if ny is None else min(ny, COORD_LIMIT),
        "op": OP_LIMIT,
    }
    for field, limit in bounds.items():
        v = np.asarray(entries.get(field, op * 0))[live]
        if v.size and (v.min() < 0 or v.max() >= limit):
            what = (f"the {COORD_BITS}-bit packed header coordinate"
                    if field != "op" else f"the {OP_BITS}-bit opcode field")
            where = "" if (nx is None or field == "op") \
                else f" and the {nx}x{ny} mesh"
            raise ValueError(
                f"program field {field!r} must be in [0, {limit}) to fit "
                f"{what}{where}; got values in "
                f"[{int(v.min())}, {int(v.max())}]")
    for field in ("addr", "data", "cmp", "not_before"):
        if field not in entries:
            continue
        v = np.asarray(entries[field])
        if v.size and (v.min(initial=0) < _I32.min
                       or v.max(initial=0) > _I32.max):
            raise ValueError(
                f"program field {field!r} exceeds the int32 packet lane "
                f"domain [{_I32.min}, {_I32.max}]; got values in "
                f"[{int(v.min())}, {int(v.max())}]")
