"""LogChecker: offline replica-log differ.

Re-creation of the reference's verification tool (test
cluster/LogChecker.java:9-37: opens two nodes' RocksDB logs offline and
diffs epoch/last/batch entries).  Opens N nodes' WAL directories read-only
and checks the Raft log-matching property over every group: on the index
range where logs overlap (above both compaction floors, up to the shorter
tail) the (term, payload) pairs must be identical.

Usable as a library (the system tests) or a CLI::

    python -m rafting_tpu.testkit.logcheck DIR1 DIR2 [DIR3 ...]
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from ..log.store import LogStore


@dataclasses.dataclass
class Divergence:
    group: int
    index: int
    kind: str          # "term" | "payload"
    a: object
    b: object
    node_a: int
    node_b: int

    def __str__(self):
        return (f"group {self.group} index {self.index}: {self.kind} "
                f"mismatch node{self.node_a}={self.a!r} "
                f"node{self.node_b}={self.b!r}")


def check_logs(wal_dirs: Sequence[str], groups: Optional[Sequence[int]] = None,
               max_groups: int = 1 << 20) -> List[Divergence]:
    """Diff N WAL directories; returns all divergences (empty = consistent).

    ``groups`` limits the check; by default every group id seen in any
    store (up to ``max_groups``) is probed via its tail."""
    stores = [LogStore(d) for d in wal_dirs]
    try:
        if groups is None:
            gset = set()
            for st in stores:
                g = 0
                # probe group ids until a long run of empties
                empty_run = 0
                while g < max_groups and empty_run < 64:
                    if st.tail(g) > 0 or st.floor(g) > 0:
                        gset.add(g)
                        empty_run = 0
                    else:
                        empty_run += 1
                    g += 1
            groups = sorted(gset)
        out: List[Divergence] = []
        for g in groups:
            for ai in range(len(stores)):
                for bi in range(ai + 1, len(stores)):
                    out.extend(_diff_pair(stores[ai], stores[bi], g, ai, bi))
        return out
    finally:
        for st in stores:
            st.close()


def _diff_pair(a: LogStore, b: LogStore, g: int, ai: int,
               bi: int) -> List[Divergence]:
    lo = max(a.floor(g), b.floor(g)) + 1
    hi = min(a.tail(g), b.tail(g))
    out = []
    for idx in range(lo, hi + 1):
        ta, tb = a.entry_term(g, idx), b.entry_term(g, idx)
        if ta != tb:
            out.append(Divergence(g, idx, "term", ta, tb, ai, bi))
            continue
        pa, pb = a.payload(g, idx), b.payload(g, idx)
        if pa != pb:
            out.append(Divergence(g, idx, "payload", pa, pb, ai, bi))
    return out


def main(argv: Sequence[str]) -> int:
    if len(argv) < 2:
        print(__doc__)
        return 2
    divs = check_logs(argv)
    if not divs:
        print(f"OK: {len(argv)} logs consistent")
        return 0
    for d in divs:
        print(d)
    return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
