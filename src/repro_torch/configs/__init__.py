"""Architecture configs of the port: ``get_config(arch)`` returns the
full (published) config, ``get_smoke_config(arch)`` a tiny same-family
variant for CPU tests. Every architecture of the JAX package is ported:
the dense minitron-4b, granite-8b (tied embeddings), mistral-nemo-12b
(q_dim below d_model) and mistral-large-123b, the Mamba2 (ssm)
mamba2-1.3b, the hybrid zamba2-2.7b, the MoE dbrx-132b and arctic-480b
(128 experts beside a dense residual MLP), the VLM backbone qwen2-vl-2b
and the encoder-decoder whisper-small."""
from __future__ import annotations

import importlib

from repro_torch.models import ModelConfig

# canonical ids as assigned (dashes/dots) -> module names
ARCH_IDS = {"minitron-4b": "minitron_4b", "granite-8b": "granite_8b",
            "mistral-nemo-12b": "mistral_nemo_12b",
            "mistral-large-123b": "mistral_large_123b",
            "mamba2-1.3b": "mamba2_1p3b", "zamba2-2.7b": "zamba2_2p7b",
            "dbrx-132b": "dbrx_132b", "arctic-480b": "arctic_480b",
            "qwen2-vl-2b": "qwen2_vl_2b", "whisper-small": "whisper_small"}


def _module(arch: str):
    arch = ARCH_IDS.get(arch, arch)
    if arch not in ARCH_IDS.values():
        raise NotImplementedError(f"arch {arch!r} is not ported to "
                                  "repro_torch yet (see ROADMAP.md, queue A)")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
