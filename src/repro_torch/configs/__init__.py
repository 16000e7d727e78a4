"""Architecture configs of the port: ``get_config(arch)`` returns the
full (published) config, ``get_smoke_config(arch)`` a tiny same-family
variant for CPU tests. Every architecture of the JAX package is ported:
the dense minitron-4b, granite-8b (tied embeddings), mistral-nemo-12b
(q_dim below d_model) and mistral-large-123b, the Mamba2 (ssm)
mamba2-1.3b, the hybrid zamba2-2.7b, the MoE dbrx-132b and arctic-480b
(128 experts beside a dense residual MLP), the VLM backbone qwen2-vl-2b
and the encoder-decoder whisper-small. ``SHAPES`` defines the assigned
input-shape set; ``cells()`` enumerates the 40 (arch × shape) dry-run
cells with applicability flags, as the JAX package's."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Tuple

from repro_torch.models import ModelConfig

ARCHS = [
    "minitron_4b", "mistral_nemo_12b", "mistral_large_123b", "granite_8b",
    "mamba2_1p3b", "qwen2_vl_2b", "dbrx_132b", "arctic_480b",
    "whisper_small", "zamba2_2p7b",
]

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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Is (arch, shape) a runnable cell? Returns (ok, reason_if_not)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: 500k decode is quadratic "
                       "in compute/KV; skipped per assignment "
                       "(run for SSM/hybrid only)")
    return True, ""


def cells() -> List[Tuple[str, str, bool, str]]:
    """All 40 (arch, shape, applicable, reason) cells."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname, spec in SHAPES.items():
            ok, why = applicable(cfg, spec)
            out.append((arch, sname, ok, why))
    return out
