"""Model zoo of the port: the dense decoder family (see ``lm``)."""
from .common import ModelConfig, params_from_reference, resolve_device
from .lm import LM


def get_model(cfg: ModelConfig, device=None) -> LM:
    return LM(cfg, device=device)


__all__ = ["ModelConfig", "LM", "get_model", "params_from_reference",
           "resolve_device"]
