from gscodec_studio_tpu_torch.strategy.default import DefaultStrategy  # noqa: F401
