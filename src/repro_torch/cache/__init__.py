"""Persistent, content-addressed saturation cache.

Equality saturation pays off only when its cost is amortized: a serving
process should pay beam-search cost once per kernel shape — across the
fleet and across boots — not once per process. This package persists
the *committed result* of ``saturate_program`` (extraction choice,
schedule order, predicted cost) keyed by content fingerprints of the
program, rule set, search configuration, and operand shapes:

* exact hit  → the choice is grafted back into a fresh SSA e-graph and
  the kernel re-emitted with the cached statement order: **no
  saturation, no beam search, no schedule search**, bit-identical
  sources to the cold path;
* warm hit (same kernel, different shapes) → the cached choice seeds
  the beam and the cached order seeds the schedule search;
* anything invalid → cold path (correctness never depends on an entry).

Enable per-config (``SaturatorConfig(cache_dir=...)``), process-wide
for the tile-op hot path (``repro_torch.kernels.ops.set_saturation_cache``),
or via the ``REPRO_SAT_CACHE`` environment variable. Telemetry lands in
``repro_torch.core.telemetry``.

A copy of the JAX package's ``repro.cache``: the keys of the default
emitter equal the reference's, so an entry is keyed by the same content
in both packages; the port's entries live in a directory of their own.
"""
from .keys import (EXTRACTOR_VERSION, FORMAT_VERSION, CacheKey,
                   cache_key_for, config_fingerprint, emitter_cache_id,
                   program_fingerprint, rules_fingerprint,
                   shapes_fingerprint)
from .serialize import (CacheInvalid, choice_to_doc, graft_choice,
                        orders_from_doc, schedule_to_doc)
from .store import (SaturationCache, default_cache_dir, entry_digest,
                    make_entry)

__all__ = [
    "EXTRACTOR_VERSION", "FORMAT_VERSION", "CacheKey", "CacheInvalid",
    "SaturationCache", "cache_key_for", "choice_to_doc",
    "config_fingerprint", "default_cache_dir", "emitter_cache_id",
    "entry_digest",
    "graft_choice", "make_entry", "orders_from_doc",
    "program_fingerprint", "rules_fingerprint", "schedule_to_doc",
    "shapes_fingerprint",
]
