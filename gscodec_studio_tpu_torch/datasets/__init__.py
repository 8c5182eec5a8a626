"""COLMAP scenes (port of gscodec_studio_tpu/datasets): the sparse-model
readers, world normalisation, ``Parser``/``Dataset``/``GSCDataset`` and the
evaluation trajectories. Numpy on the host."""
