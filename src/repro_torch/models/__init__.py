"""The model stack of the port: layers, attention, Mamba-2 mixers, MoE,
and the decoder-only LMs built of them (the dense / MoE / VLM
``Transformer``, the ``Mamba2LM`` and the ``Jamba`` hybrid; Whisper is a
later slice, see :func:`get_model`)."""
from .api import get_model  # noqa: F401
