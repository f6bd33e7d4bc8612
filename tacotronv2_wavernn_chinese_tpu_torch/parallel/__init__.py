"""Multi-process training and generation: the process group, the mesh and its collectives, fold-sharded WaveRNN generation and WaveRNN tensor parallelism."""
