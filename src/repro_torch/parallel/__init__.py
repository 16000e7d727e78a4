"""The port of :mod:`repro.parallel`: gradient compression for the DP
all-reduce (:mod:`.compression`). The reference's ``ctx`` (the active
mesh), ``sharding`` (parameter, optimizer, batch and cache placements)
and ``pipeline_pp`` (pipeline stages) wait for the multi-device layer
(ROADMAP A14.3)."""
from .compression import MODES, Compressor, compressed_grads

__all__ = ["MODES", "Compressor", "compressed_grads"]
