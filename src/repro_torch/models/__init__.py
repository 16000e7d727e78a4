"""Model zoo of the port: the dense, Mamba2 (ssm), Zamba2 hybrid, MoE and
Qwen2-VL (vlm) decoder families (see ``lm``) and the Whisper
encoder-decoder (see ``whisper``)."""
from .common import (ModelConfig, MoEConfig, SSMConfig,
                     params_from_reference, resolve_device)
from .lm import LM
from .whisper import EncDecLM


def get_model(cfg: ModelConfig, device=None):
    if cfg.family == "encdec":
        return EncDecLM(cfg, device=device)
    return LM(cfg, device=device)


__all__ = ["ModelConfig", "MoEConfig", "SSMConfig", "LM", "EncDecLM",
           "get_model", "params_from_reference", "resolve_device"]
