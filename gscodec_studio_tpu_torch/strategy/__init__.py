from gscodec_studio_tpu_torch.strategy.default import DefaultStrategy  # noqa: F401
from gscodec_studio_tpu_torch.strategy.mcmc import MCMCStrategy  # noqa: F401
from gscodec_studio_tpu_torch.strategy.stg import (  # noqa: F401
    ModifiedSTGStrategy,
    STGStrategy,
)
