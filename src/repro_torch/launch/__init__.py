"""Entry points of the port: the train, prefill and serve steps
(:mod:`.step`), the training launcher (:mod:`.train`) and the
continuous-batching server (:mod:`.serve`)."""
