"""On-disk content-addressed store for saturation results.

Layout (all names content-derived, see :mod:`repro_torch.cache.keys`)::

    <root>/<kernel>/<warm_key[:24]>/<exact_key[:24]>.json

One JSON file per (program, shapes, config) — the committed extraction
choice, schedule order, and predicted cost. A lookup first tries the
exact file (→ ``"hit"``: replay, no search); otherwise any sibling in
the same warm directory is the same kernel under the same rules/config
with different shapes (→ ``"warm"``: seed the searches from it).

Robustness contract (exercised by ``tests/test_torch_cache.py``):

* writes go to a temp file in the same directory and land via
  ``os.replace`` — atomic on POSIX, so concurrent writers can't clobber
  each other or expose torn entries;
* corrupt / truncated / version-mismatched entries are *ignored* (and
  counted in telemetry), never trusted — the caller falls back to the
  cold path;
* the full keys are embedded in each entry and re-validated on load, so
  a truncated-digest filename collision degrades to a miss;
* every entry carries a sha256 ``digest`` over its semantic fields
  (choice, schedule, costs) that is re-verified on load, so corruption
  that stays valid JSON still degrades to a miss, never a wrong replay.

Trust model: entries are replayed into generated code, so the cache
root must be private to the user. A root this process creates is made
``0700``; a pre-existing root is refused (cache silently off, counted
in telemetry) unless it is a real directory owned by the current uid
with no group/other write bits — so a world-writable location another
local user pre-created can never feed us entries. Entry *contents* are
additionally validated structurally at graft time (see
:mod:`repro_torch.cache.serialize`).
"""
from __future__ import annotations

import errno
import hashlib
import json
import os
import stat
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.telemetry import telemetry
from repro_torch.runtime import chaos

from .keys import EXTRACTOR_VERSION, FORMAT_VERSION, CacheKey
from .serialize import CacheInvalid

_DIGEST_CHARS = 24

# The fields an entry's integrity digest seals — everything that feeds
# replay. Keys/versions are validated separately; cold_report and
# created_unix are informational.
_SEALED_FIELDS = ("choice", "schedule", "predicted", "dag_cost",
                  "tree_cost")


def default_cache_dir() -> Path:
    """User-private default cache location:
    ``$XDG_CACHE_HOME/repro_torch/sat_cache`` (or
    ``~/.cache/repro_torch/sat_cache``), apart from the JAX package's —
    never a shared world-writable directory like ``/tmp``, where any
    local user could pre-create the path and plant entries."""
    base = os.environ.get("XDG_CACHE_HOME")
    root = Path(base) if base else Path.home() / ".cache"
    return root / "repro_torch" / "sat_cache"


def entry_digest(doc: Dict[str, Any]) -> str:
    """sha256 over the canonical JSON of the entry's sealed fields."""
    payload = json.dumps([doc.get(k) for k in _SEALED_FIELDS],
                         sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(payload.encode()).hexdigest()


class SaturationCache:
    def __init__(self, root):
        self.root = Path(root)
        self._usable: Optional[bool] = None

    # -- root trust ----------------------------------------------------------
    def _root_usable(self) -> bool:
        """Create-or-verify the cache root. A root we create is 0700;
        a pre-existing one must be a non-symlink directory owned by the
        current uid with no group/other write permission. Anything else
        disables the cache for this instance (recorded once)."""
        if self._usable is not None:
            return self._usable
        try:
            os.makedirs(self.root, mode=0o700, exist_ok=True)
            st = os.stat(self.root, follow_symlinks=False)
            if not stat.S_ISDIR(st.st_mode):
                raise OSError(f"{self.root} is not a directory")
            if hasattr(os, "getuid") and st.st_uid != os.getuid():
                raise OSError(f"{self.root} is owned by uid {st.st_uid}, "
                              f"not {os.getuid()}")
            if st.st_mode & (stat.S_IWGRP | stat.S_IWOTH):
                raise OSError(f"{self.root} is group/other-writable "
                              f"(mode {stat.S_IMODE(st.st_mode):o})")
        except OSError as e:
            telemetry().record_invalid(
                "<root>", f"untrusted cache root, cache disabled: {e}")
            self._usable = False
            return False
        self._usable = True
        return True

    # -- paths --------------------------------------------------------------
    def _warm_dir(self, key: CacheKey) -> Path:
        return self.root / key.kernel / key.warm_key[:_DIGEST_CHARS]

    def _entry_path(self, key: CacheKey) -> Path:
        return self._warm_dir(key) / \
            f"{key.exact_key[:_DIGEST_CHARS]}.json"

    # -- load/validate -------------------------------------------------------
    def _load(self, path: Path, key: CacheKey, *, exact: bool
              ) -> Dict[str, Any]:
        try:
            # chaos site: a failing cache volume (EIO) exercises exactly
            # this handler — the production degrade-to-miss path
            chaos.maybe_raise_os("cache_read_io", errno.EIO,
                                 f"read {path.name}")
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CacheInvalid(f"unreadable entry {path.name}: {e}") from e
        if chaos.chaos_point("cache_corrupt"):
            # tamper a sealed field post-parse: the digest check below
            # must reject it (corruption that stays valid JSON)
            doc = dict(doc)
            doc["dag_cost"] = float(doc.get("dag_cost") or 0.0) + 1.0
        if not isinstance(doc, dict):
            raise CacheInvalid(f"entry {path.name} is not an object")
        if doc.get("format") != FORMAT_VERSION:
            raise CacheInvalid(f"format {doc.get('format')!r} != "
                               f"{FORMAT_VERSION}")
        if doc.get("extractor_version") != EXTRACTOR_VERSION:
            raise CacheInvalid(
                f"extractor version {doc.get('extractor_version')!r} != "
                f"{EXTRACTOR_VERSION}")
        dk = doc.get("key", {})
        if dk.get("warm") != key.warm_key:
            raise CacheInvalid("warm-key mismatch (stale rules/config "
                               "or digest collision)")
        if exact and dk.get("exact") != key.exact_key:
            raise CacheInvalid("exact-key mismatch")
        if "choice" not in doc:
            raise CacheInvalid("entry has no choice")
        if doc.get("digest") != entry_digest(doc):
            raise CacheInvalid("content digest mismatch (corrupt or "
                               "tampered entry)")
        return doc

    def lookup(self, key: CacheKey
               ) -> Tuple[Optional[Dict[str, Any]], str]:
        """Returns ``(entry, status)`` with status in
        ``{"hit", "warm", "miss"}``; entry is None on a miss."""
        if not self._root_usable():
            return None, "miss"
        exact = self._entry_path(key)
        if exact.is_file():
            try:
                return self._load(exact, key, exact=True), "hit"
            except CacheInvalid as e:
                telemetry().record_invalid(key.kernel, str(e))
        warm_dir = self._warm_dir(key)
        if warm_dir.is_dir():
            for path in sorted(warm_dir.glob("*.json")):
                if path == exact:
                    continue
                try:
                    return self._load(path, key, exact=False), "warm"
                except CacheInvalid as e:
                    telemetry().record_invalid(key.kernel, str(e))
        return None, "miss"

    # -- store ---------------------------------------------------------------
    def put(self, key: CacheKey, entry: Dict[str, Any]) -> bool:
        """Atomically persist ``entry``; False on filesystem trouble
        (caching is best-effort, never fatal). The entry is stamped with
        its content digest so ``_load`` can detect corruption that stays
        valid JSON."""
        if not self._root_usable():
            return False
        path = self._entry_path(key)
        tmp = path.with_name(
            f".{path.stem}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp")
        try:
            entry = dict(entry)
            entry["digest"] = entry_digest(entry)
            path.parent.mkdir(parents=True, exist_ok=True)
            # chaos site: ENOSPC from the atomic-write path exercises
            # the cache-disabled-with-telemetry degrade below
            chaos.maybe_raise_os("cache_write_io", errno.ENOSPC,
                                 f"write {path.name}")
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(entry, f, sort_keys=True, separators=(",", ":"))
            os.replace(tmp, path)   # atomic: readers see old or new, whole
        except (OSError, TypeError, ValueError) as e:
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass
            if isinstance(e, OSError):
                # ENOSPC / EIO / read-only fs: a filesystem that cannot
                # take writes won't heal mid-process — disable this
                # cache instance (matching the untrusted-root behavior)
                # instead of paying a failed write per build, and say so
                telemetry().record_invalid(
                    key.kernel, f"cache write failed, cache disabled "
                    f"for this process: {e}")
                self._usable = False
            return False
        telemetry().record_store(key.kernel)
        return True

    def stats(self) -> Dict[str, int]:
        entries = 0
        kernels = set()
        if self.root.is_dir():
            for p in self.root.rglob("*.json"):
                entries += 1
                kernels.add(p.parts[len(self.root.parts)])
        return {"entries": entries, "kernels": len(kernels)}


def make_entry(key: CacheKey, *, choice_doc: Dict[str, Any],
               schedule_doc: Optional[Dict[str, Any]],
               predicted: Optional[Dict[str, Any]],
               dag_cost: float, report: Dict[str, Any]
               ) -> Dict[str, Any]:
    """Assemble one versioned on-disk entry."""
    return {
        "format": FORMAT_VERSION,
        "extractor_version": EXTRACTOR_VERSION,
        "key": {"warm": key.warm_key, "exact": key.exact_key,
                "components": dict(key.components)},
        "choice": choice_doc,
        "schedule": schedule_doc,
        "predicted": predicted,
        "dag_cost": dag_cost,
        "cold_report": report,
        "created_unix": time.time(),
    }
