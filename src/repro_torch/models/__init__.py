from repro_torch.models.api import DecoderLM, EmbedsLM, EncDecLM, get_model
from repro_torch.models.common import EncoderCfg, ModelConfig

__all__ = ["DecoderLM", "EmbedsLM", "EncDecLM", "EncoderCfg", "ModelConfig", "get_model"]
