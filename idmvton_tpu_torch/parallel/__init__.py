"""Multi-process parallelism: the mesh, data parallelism and ZeRO-1,
tensor, spatial and pipeline parallelism, and a multi-rank dry run."""
