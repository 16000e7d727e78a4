"""The emitter registry: one front door for every code generator of the
port, the counterpart of :mod:`repro.core.emit`.

====================  ===================================  ================
name                  generator                            produces
====================  ===================================  ================
``torch``             :class:`TorchCodeGenerator`          ``GeneratedKernel``
``triton``            :class:`TritonGenerator`             ``TritonKernel``
``triton_pipelined``  :class:`TritonPipelinedGenerator`    ``TritonKernel``
====================  ===================================  ================

``torch`` is the plain version (the JAX package's ``jax``), ``triton``
the Hopper tile kernel (its ``pallas``) and ``triton_pipelined`` the
persistent, software-pipelined form of it (its ``pallas_pipelined``).

``get_emitter(name)`` returns a small :class:`Emitter` facade; its
``emit(ssa, extraction, **options)`` builds the generator and runs it,
and ``info`` carries the registry metadata, including the ``version``
that enters the cache key for a non-default emitter (see
:func:`emitter_cache_id` and ``repro_torch.cache.keys.config_fingerprint``).

The port never had class names from before a registry, so unlike the
JAX package it keeps no deprecated aliases.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

EMITTER_NAMES: Tuple[str, ...] = ("torch", "triton", "triton_pipelined")

# Bump an emitter's version whenever its emitted source for a fixed
# (choice, schedule) changes: non-default emitters carry name@version in
# the cache config fingerprint, so cached replays never mix emitters.
_EMITTER_VERSIONS: Dict[str, int] = {"torch": 1, "triton": 1,
                                     "triton_pipelined": 1}
# Emitters that add no key component, so their keys equal the JAX
# package's keys of its default emitters.
_DEFAULT_EMITTERS = (None, "torch", "triton")


@dataclasses.dataclass(frozen=True)
class EmitterInfo:
    name: str      # registry name
    version: int   # cache-key version (see _EMITTER_VERSIONS)
    target: str    # "torch" (GeneratedKernel) or "triton" (TritonKernel)


class Emitter:
    """Facade over one generator class.

    ``emit`` accepts the common generator options (``bulk``,
    ``fn_name``, ``reuse_temps``, ``schedule``, ``sched_cost_model`` and,
    for the torch target, ``extra_fns``) and returns the generator's
    product: a ``GeneratedKernel`` or a ``TritonKernel``.
    """

    info: EmitterInfo

    # resolved lazily: the generator modules import this one's clients
    @property
    def generator_cls(self):
        raise NotImplementedError

    def emit(self, ssa, extraction, **options):
        gen = self.generator_cls(ssa, extraction, **options)
        if self.info.target == "triton":
            return gen.generate_triton()
        return gen.generate()


class _TorchEmitter(Emitter):
    info = EmitterInfo("torch", _EMITTER_VERSIONS["torch"], "torch")

    @property
    def generator_cls(self):
        from .torchgen import TorchCodeGenerator
        return TorchCodeGenerator


class _TritonEmitter(Emitter):
    info = EmitterInfo("triton", _EMITTER_VERSIONS["triton"], "triton")

    @property
    def generator_cls(self):
        from .tritongen import TritonGenerator
        return TritonGenerator


class _TritonPipelinedEmitter(Emitter):
    info = EmitterInfo("triton_pipelined",
                       _EMITTER_VERSIONS["triton_pipelined"], "triton")

    @property
    def generator_cls(self):
        from .tritongen import TritonPipelinedGenerator
        return TritonPipelinedGenerator


_REGISTRY: Dict[str, Emitter] = {
    "torch": _TorchEmitter(),
    "triton": _TritonEmitter(),
    "triton_pipelined": _TritonPipelinedEmitter(),
}


def get_emitter(name: str) -> Emitter:
    """The registered emitter, by name (``EMITTER_NAMES``)."""
    em = _REGISTRY.get(name)
    if em is None:
        raise ValueError(f"unknown emitter {name!r}; "
                         f"expected one of {EMITTER_NAMES}")
    return em


def emitter_cache_id(name: Optional[str]) -> Optional[str]:
    """The ``name@v{version}`` token a config fingerprint carries for a
    non-default emitter, or None for the defaults (None, ``"torch"``,
    ``"triton"``), whose keys equal the JAX package's."""
    if name in _DEFAULT_EMITTERS:
        return None
    if name not in _EMITTER_VERSIONS:
        raise ValueError(f"unknown emitter {name!r}; "
                         f"expected one of {EMITTER_NAMES}")
    return f"{name}@v{_EMITTER_VERSIONS[name]}"
