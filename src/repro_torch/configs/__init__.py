"""Architecture configs of the port: ``get_config(arch)`` returns the
full (published) config, ``get_smoke_config(arch)`` a tiny same-family
variant for CPU tests. The dense minitron-4b and the Mamba2 (ssm)
mamba2-1.3b are ported so far; the other architectures of the JAX
package come with their families (ROADMAP queue A)."""
from __future__ import annotations

import importlib

from repro_torch.models import ModelConfig

# canonical ids as assigned (dashes/dots) -> module names
ARCH_IDS = {"minitron-4b": "minitron_4b", "mamba2-1.3b": "mamba2_1p3b"}


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
