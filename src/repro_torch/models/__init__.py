"""Model zoo of the port: the dense and Mamba2 (ssm) decoder families
(see ``lm``)."""
from .common import (ModelConfig, SSMConfig, params_from_reference,
                     resolve_device)
from .lm import LM


def get_model(cfg: ModelConfig, device=None) -> LM:
    return LM(cfg, device=device)


__all__ = ["ModelConfig", "SSMConfig", "LM", "get_model", "params_from_reference",
           "resolve_device"]
