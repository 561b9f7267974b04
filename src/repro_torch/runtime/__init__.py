"""The fault-tolerant training runtime of the port, one card (counterpart
of ``repro.runtime``)."""
from .trainer import FaultInjector, Trainer, TrainerConfig

__all__ = ["FaultInjector", "Trainer", "TrainerConfig"]
