"""Validation-artifact writer of the port's tools (stdlib only).

The port's own copy of ``PhaseLog`` from the repo's ``tools/_artifact.py``:
a run persists its raw evidence — seed, config, per-phase numbers,
platform, wall-clock — as a gzip-compressed JSON file (``.json.gz``)
under ``ARTIFACT_DIR`` (the repo's ``artifacts/``).  ``argv`` is the
command line the artifact records (``sys.argv`` unless the caller sets
it).
"""

from __future__ import annotations

import gzip
import json
import os
import sys
import time

ARTIFACT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "artifacts")


class PhaseLog:
    """Collects (phase, numbers) pairs and mirrors lines to stdout."""

    def __init__(self, name: str, seed: int, config: dict):
        self.name = name
        self.seed = seed
        self.config = config
        self.phases: list = []
        self.argv = sys.argv[1:]
        self.t0 = time.time()

    def phase(self, title: str, **numbers) -> None:
        self.phases.append({"phase": title, "t_s": round(time.time()
                                                         - self.t0, 2),
                            **numbers})
        nums = " ".join(f"{k}={v}" for k, v in numbers.items())
        print(f"[{self.name}] {title}: {nums}", flush=True)

    def save(self, platform: str, ok: bool = True) -> str:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        stem = f"{self.name}_{platform}"
        seq = 0
        # Sequence numbers must not collide with either form —
        # committed history holds bare .json, new runs write .json.gz.
        while any(os.path.exists(os.path.join(
                ARTIFACT_DIR, f"{stem}_{seq:03d}.json{ext}"))
                for ext in ("", ".gz")):
            seq += 1
        path = os.path.join(ARTIFACT_DIR, f"{stem}_{seq:03d}.json.gz")
        doc = {
            "name": self.name,
            "ok": ok,
            "seed": self.seed,
            "platform": platform,
            "config": self.config,
            "phases": self.phases,
            "total_s": round(time.time() - self.t0, 2),
            "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "argv": self.argv,
        }
        with gzip.open(path, "wt") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        print(f"[{self.name}] artifact saved: {path}", flush=True)
        return path
