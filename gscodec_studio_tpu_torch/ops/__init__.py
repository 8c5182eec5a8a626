"""Splat ops: projection, SH, the fused tile rasterizer (raster_v2), the
legacy v1 tile rasterizer (rasterize_pallas) and its binning (isect).
The names exported here are the JAX package's ``ops`` names."""

from gscodec_studio_tpu_torch.ops.quat import (  # noqa: F401
    normalize_quat,
    quat_to_rotmat,
    quat_scale_to_covar,
    quat_scale_to_covar_preci,
)
from gscodec_studio_tpu_torch.ops.transforms import world_to_cam  # noqa: F401
from gscodec_studio_tpu_torch.ops.projection import (  # noqa: F401
    persp_proj,
    ortho_proj,
    fisheye_proj,
    proj,
    fully_fused_projection,
)
from gscodec_studio_tpu_torch.ops.sh import (  # noqa: F401
    spherical_harmonics,
    num_sh_bases,
)
from gscodec_studio_tpu_torch.ops.isect import (  # noqa: F401
    isect_tiles,
    isect_offset_encode,
)
from gscodec_studio_tpu_torch.ops.relocation import (  # noqa: F401
    compute_relocation,
)
