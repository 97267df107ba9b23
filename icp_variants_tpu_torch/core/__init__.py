from icp_variants_tpu_torch.core import cloud, se3  # noqa: F401
from icp_variants_tpu_torch.core.cloud import Cloud  # noqa: F401
