"""The port of :mod:`repro.parallel`, the distribution layer: sharding
rules (DP/TP/EP/SP/FSDP) as DTensor placements (:mod:`.sharding`), the
activation sharding context (:mod:`.ctx`), GPipe pipeline stages over
point-to-point sends (:mod:`.pipeline_pp`), and gradient compression for
the DP all-reduce (:mod:`.compression`)."""
from . import ctx
from .compression import MODES, Compressor, compressed_grads
from .sharding import (P, batch_specs, cache_specs, distribute, mesh_axes,
                       opt_state_specs, param_specs, placements, to_named)

__all__ = ["ctx", "P", "batch_specs", "cache_specs", "distribute",
           "mesh_axes", "opt_state_specs", "param_specs", "placements",
           "to_named", "MODES", "Compressor", "compressed_grads"]
