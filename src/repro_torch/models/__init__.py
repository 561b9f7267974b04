"""The model stack of the port: layers, attention, Mamba-2 mixers, MoE,
and the models built of them (the dense / MoE / VLM ``Transformer``, the
``Mamba2LM``, the ``Jamba`` hybrid and the ``Whisper`` encoder-decoder;
see :func:`get_model`), on one card or on a mesh of ranks."""
from .api import get_model  # noqa: F401
