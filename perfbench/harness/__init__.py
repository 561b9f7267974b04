"""The benchmark's general code: it reads a cell's configuration, traffic
and metrics as files named in ``BENCHMARK.json`` and holds nothing of
any one of them (:mod:`.spec`), holds the seed's streams
(:mod:`.traffic`), draws the weights (:mod:`.weights`), runs the window
over a mix's driver (:mod:`.window`), reads
the profiler's trace (:mod:`.trace`) and decides ``correct``
(:mod:`.judge`); :mod:`.cell` runs one cell once."""
