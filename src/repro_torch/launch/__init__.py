"""Serving entry points of the port: the prefill and serve steps
(:mod:`.step`) and the continuous-batching server (:mod:`.serve`)."""
