"""The model stack of the port: layers, attention, Mamba-2 mixers, MoE and
the Jamba hybrid (the hybrid serving path; the other families are later
slices, see :func:`get_model`)."""
from .api import get_model  # noqa: F401
