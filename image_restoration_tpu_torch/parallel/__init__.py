"""Multi-rank execution: the global batch of a data-parallel step, the halo
exchange and the multi-rank dry run (image_restoration_tpu/parallel)."""
