"""Shared file-backed JSON memo (autotuner + planner measurement caches).

The port's own copy of `repro/filecache.py` (the port imports nothing of
the JAX package), with the same envelope and environment rules.

One convention, two users (kernels/backproject/tune.py, planner/measure.py):
an env var names the cache file ("off"/"0"/""/"none" disables persistence,
unset falls back to a default under ~/.cache/repro), entries live under a
versioned envelope ({"version": N, "entries": {json(key): entry}}), writes
are read-modify-write with an atomic os.replace and best-effort on failure
(read-only filesystems just skip persistence).
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional


class JsonFileCache:
    """File half of a two-level memo: callers keep their own in-process
    dict and decide what counts as a usable hit; this object only moves
    JSON-able entries to and from disk. `hits` is a public counter the
    caller increments when a disk entry is actually served
    (observability/tests)."""

    def __init__(self, env_var: str, default_filename: str,
                 version: int = 1, path: Optional[str] = None):
        self.env_var = env_var
        self.default_filename = default_filename
        self.version = version
        self.hits = 0
        # Explicit path wins over env resolution — callers that manage
        # their own file (tests, the calibration store's save/load CLI)
        # bypass the env switch entirely.
        self._path_override = path

    def path(self) -> Optional[str]:
        """Resolved cache path, or None when persistence is disabled."""
        if self._path_override is not None:
            return self._path_override
        env = os.environ.get(self.env_var)
        if env is not None:
            if env.strip().lower() in ("", "0", "off", "none"):
                return None
            return env
        return os.path.join(os.path.expanduser("~"), ".cache", "repro",
                            self.default_filename)

    @staticmethod
    def key_str(key: tuple) -> str:
        return json.dumps(list(key))

    def _load(self, path: str) -> dict:
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(data, dict) or data.get("version") != self.version:
            return {}  # stale schema: ignore, will be rewritten
        entries = data.get("entries")
        return entries if isinstance(entries, dict) else {}

    def get(self, key: tuple) -> Any:
        """The stored entry for `key`, or None. Does NOT bump `hits` —
        the caller counts only entries it accepts."""
        path = self.path()
        if path is None:
            return None
        return self._load(path).get(self.key_str(key))

    def entries(self) -> dict:
        """All stored entries, `{key_str: entry}` — the bulk-read view the
        calibration store fits from (planner/calibrate.py). Empty dict when
        persistence is disabled or the file is missing/stale."""
        path = self.path()
        if path is None:
            return {}
        return self._load(path)

    def put(self, key: tuple, entry: Any) -> None:
        path = self.path()
        if path is None:
            return
        entries = self._load(path)
        entries[self.key_str(key)] = entry
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump({"version": self.version, "entries": entries}, f)
            os.replace(tmp, path)
        except OSError:
            pass  # best-effort: a missing cache is never an error
