"""Model zoo of the port: the dense, Mamba2 (ssm), Zamba2 hybrid and MoE
decoder families (see ``lm``)."""
from .common import (ModelConfig, MoEConfig, SSMConfig,
                     params_from_reference, resolve_device)
from .lm import LM


def get_model(cfg: ModelConfig, device=None) -> LM:
    return LM(cfg, device=device)


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "LM", "get_model",
           "params_from_reference", "resolve_device"]
