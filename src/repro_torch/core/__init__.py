"""Constants of the cycle-level mesh network shared by the whole port."""
