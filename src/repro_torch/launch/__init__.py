"""Entry points of the port: the train, prefill and serve steps and
``cell_rules`` (:mod:`.step`), the training launcher (:mod:`.train`), the
continuous-batching server (:mod:`.serve`) and the meshes and the rank
launcher (:mod:`.mesh`)."""
