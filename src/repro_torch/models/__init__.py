from repro_torch.models.api import DecoderLM, get_model
from repro_torch.models.common import ModelConfig

__all__ = ["DecoderLM", "ModelConfig", "get_model"]
