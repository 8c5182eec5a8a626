from gscodec_studio_tpu_torch.compression.png_compression import (  # noqa: F401,E501
    PngCompression,
    compressed_size,
)
from gscodec_studio_tpu_torch.compression.entropy_coding import (  # noqa: F401,E501
    EntropyCodingCompression,
)
from gscodec_studio_tpu_torch.compression.outlier_filter import (  # noqa: F401,E501
    filter_splats,
)
from gscodec_studio_tpu_torch.compression.sort import sort_splats  # noqa: F401
