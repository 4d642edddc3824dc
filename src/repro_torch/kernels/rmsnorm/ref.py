"""Plain PyTorch RMSNorm: the oracle ``models/common.rmsnorm``."""
from repro_torch.models.common import rmsnorm as rmsnorm_ref  # noqa: F401
