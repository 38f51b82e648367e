"""A whole cluster sharded over ranks of ``torch.distributed``: the twin of
``dryrun_multichip`` in the repo's ``__graft_entry__.py``.

    python -m rafting_tpu_torch.tools.dryrun_multichip --world 1
    python -m rafting_tpu_torch.tools.dryrun_multichip --world 4 --backend gloo
    python -m rafting_tpu_torch.tools.dryrun_multichip --world 4 --backend gloo --device cpu
        [--mesh AxB] [--nodes N] [--groups G]

``--world W`` ranks run one cluster on a (node shards x group shards)
mesh (``core/shard.py``).  The mesh is factored as the reference factors
it: node shards = the largest of 4, 3, 2, 1 that divides W, the rest on
the group axis (``--mesh`` sets it).  The cluster defaults to one node
per node shard and 16,384 groups per group shard (log_slots 32, batch 4,
max_submit 4, election 10, heartbeat 3, seed 0, two submissions per group
and tick); each rank builds the full boot state, keeps its slice
(``shard_cluster``) and runs 64 ticks of ``run_cluster_ticks`` on it.
The slices are gathered back and checked: one leader per group, every
group committed.  The last line is
``dryrun_multichip OK: platform=..., mesh=(a node x b group), G=..., committed=...``.

The backend is the caller's choice.  ``nccl`` (the default) gives every
rank its own card: with no card, or fewer cards than ranks, the tool
exits non-zero and never moves to the CPU.  ``gloo`` runs the ranks on
the CPU (``--device cpu``) or all on one card: there every collective is
staged through host tensors (``Mesh.staged``).  One card proves the
sharded path right; it measures no multi-GPU rate.

Ranks are processes started with ``spawn`` (CUDA forbids ``fork``) and
meet through a ``file://`` rendezvous in a fresh temporary directory, so
runs side by side never collide on a port; a world of 1 runs in the
calling process.  On the card the quorum kernel is built once, here,
before the ranks start, and each rank loads the built library.  Each
rank reports its ms/tick, its kernel launches and its local shapes; on
the card it also holds the kernel against its plain version on the
operands of its last launch.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import os
import pickle
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

RANK_TIMEOUT_S = 600


def factor(world: int) -> tuple:
    """``_dryrun_inner``'s mesh: node shards = the largest of 4, 3, 2, 1
    that divides ``world``, the rest on the group axis."""
    a = max(x for x in (4, 3, 2, 1) if world % x == 0)
    return a, world // a


def dryrun_job(mesh: tuple, nodes: int | None = None,
               groups: int | None = None) -> dict:
    """The reference dry run's cluster on ``mesh``, for 64 ticks."""
    a, b = mesh
    return {"cfg": dict(n_groups=groups or 16_384 * b, n_peers=nodes or a,
                        log_slots=32, batch=4, max_submit=4,
                        election_ticks=10, heartbeat_ticks=3),
            "mesh": (a, b), "ticks": 64, "seed": 0, "submit": 2,
            "nemesis": None}


def full_cluster(job: dict, device):
    """``job``'s whole cluster at boot on ``device``: ``(cfg, (states,
    inflight, info, conn, submit))``, every node from ``init_state`` with
    the job's seed, all links up, ``submit`` per group and tick."""
    from ..core.types import (
        EngineConfig, Messages, StepInfo, init_state, stack_states,
    )
    cfg = EngineConfig(**job["cfg"])
    N, G = cfg.n_peers, cfg.n_groups
    return cfg, (stack_states([init_state(cfg, i, seed=job["seed"],
                                          device=device)
                               for i in range(N)]),
                 Messages.empty(cfg, device, lead=(N,)),
                 StepInfo.empty(cfg, device, lead=(N,)),
                 torch.ones((N, N), dtype=torch.bool, device=device),
                 torch.full((N, G), job["submit"], dtype=torch.int32,
                            device=device))


def _schedule(job: dict, n_peers: int, device):
    from ..testkit import nemesis
    return nemesis.chaos_mix(n_peers, job["ticks"],
                             seed=job["nemesis"]["seed"], device=device)


def run_unsharded(job: dict, device):
    """``job`` on one device, unsharded: the final ``(states, inflight,
    info)`` that the sharded run must equal."""
    from ..core.sim import run_cluster_ticks, run_cluster_ticks_nemesis
    cfg, (states, inflight, info, conn, submit) = full_cluster(job, device)
    if job.get("nemesis"):
        return run_cluster_ticks_nemesis(
            cfg, states, inflight, info,
            _schedule(job, cfg.n_peers, device), submit, device=device)
    return run_cluster_ticks(cfg, job["ticks"], states, inflight, info,
                             conn, submit, device=device)


@contextlib.contextmanager
def _last_quorum_operands(keep: list):
    """Keep in ``keep`` the operands of the tick's last quorum-kernel
    call (phase 10 of ``node_step``), in ``quorum_commit_ref``'s order."""
    from ..core import step
    real = step.quorum_commit

    def quorum_commit(cfg, match_full, log, commit, own_from, can_lead,
                      voters, voters_new):
        keep[:] = (match_full, own_from, log.last, commit, can_lead,
                   voters, voters_new)
        return real(cfg, match_full, log, commit, own_from, can_lead,
                    voters, voters_new)
    step.quorum_commit = quorum_commit
    try:
        yield
    finally:
        step.quorum_commit = real


def run_job(job: dict, mesh) -> dict:
    """One rank's part of a sharded run (``job`` as :func:`dryrun_job`
    builds it; ``"nemesis": {"seed": s}`` runs ``ticks`` ticks of
    ``chaos_mix`` through ``run_cluster_ticks_nemesis`` instead).  Every
    rank returns its numbers; rank 0 also the gathered final
    ``(states, inflight, info)`` as numpy trees.  On the card each rank
    also holds the kernel against its plain version on the operands of
    its last launch (``kernel_err``, after the counts were read); rank 0
    returns those operands as numpy arrays (``operands``)."""
    from ..bridge import state_to_numpy
    from ..core.shard import (
        gather_cluster, shard_cluster, shard_fault_schedule,
    )
    from ..core.sim import (
        committed_entries, run_cluster_ticks, run_cluster_ticks_nemesis,
    )
    from ..ops import quorum

    dev = mesh.device
    cuda = dev.type == "cuda"
    cfg, full = full_cluster(job, dev)
    T = job["ticks"]
    states, inflight, info, conn, submit = shard_cluster(mesh, cfg, *full)
    sched = None
    if job.get("nemesis"):
        sched = shard_fault_schedule(mesh, _schedule(job, cfg.n_peers, dev))
    del full
    if cuda:
        torch.cuda.synchronize(dev)
    dist.barrier()
    operands = []
    quorum.reset_launch_counts()
    t0 = time.perf_counter()
    with _last_quorum_operands(operands):
        if sched is None:
            states, inflight, info = run_cluster_ticks(
                cfg, T, states, inflight, info, conn, submit, mesh=mesh)
        else:
            states, inflight, info = run_cluster_ticks_nemesis(
                cfg, states, inflight, info, sched, submit, mesh=mesh)
    if cuda:
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    out = {"rank": dist.get_rank(), "coords": mesh.coords,
           "ms_per_tick": secs / T * 1e3,
           "launches": quorum.launch_counts["quorum_commit"],
           "strided": quorum.strided_launches["quorum_commit"],
           "local_term": tuple(states.term.shape),
           "local_ae_valid": tuple(inflight.ae_valid.shape),
           "committed": int(committed_entries(states, mesh)),
           "foreign": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "rafting_tpu"))}
    if cuda:
        got = quorum.quorum_commit_cuda(*operands)
        want = quorum.quorum_commit_ref(*operands)
        out["kernel_err"] = int((got.long() - want.long()).abs().max())
        if out["rank"] == 0:
            out["operands"] = tuple(t.cpu().numpy() for t in operands)
    gathered = gather_cluster(mesh, states, inflight, info)
    if out["rank"] == 0:
        out["state"], out["inflight"], out["info"] = (
            state_to_numpy(t) for t in gathered)
    return out


def _rank_main(rank: int, world: int, backend: str, device: str, rdv: str,
               job: dict, out_dir: str) -> None:
    from ..core.shard import init_mesh

    # One host: the ranks talk over the loopback interface.
    for var in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):
        os.environ.setdefault(var, "lo")
    if device == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        backend, init_method=f"file://{rdv}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
        device_id=dev if backend == "nccl" else None)
    try:
        res = run_job(job, init_mesh(tuple(job["mesh"]), dev))
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def check_backend(world: int, backend: str, device: str) -> None:
    """Refuse a run the machine cannot give as asked (SystemExit)."""
    if backend not in ("nccl", "gloo") or device not in ("cuda", "cpu"):
        raise SystemExit(f"dryrun_multichip: backend {backend!r} on device "
                         f"{device!r}: want nccl|gloo on cuda|cpu")
    if device == "cpu":
        if backend != "gloo":
            raise SystemExit("dryrun_multichip: the CPU runs only over "
                             "gloo (--backend gloo --device cpu)")
        return
    if not torch.cuda.is_available():
        raise SystemExit("dryrun_multichip: no CUDA device (pass "
                         "--backend gloo --device cpu to run on the CPU)")
    if backend == "nccl" and world > torch.cuda.device_count():
        raise SystemExit(f"dryrun_multichip: nccl gives every rank its own "
                         f"card: {world} ranks, {torch.cuda.device_count()} "
                         f"cards (--backend gloo shares one card)")


def launch(job: dict, world: int, backend: str, device: str) -> list:
    """Run ``job`` on ``world`` ranks; each rank's result, by rank."""
    check_backend(world, backend, device)
    a, b = job["mesh"]
    if a * b != world:
        raise SystemExit(f"dryrun_multichip: mesh {a} x {b} on {world} "
                         f"ranks")
    if device == "cuda":
        from ..ops import _build
        _build.build("quorum_commit")
    tmp = tempfile.mkdtemp(prefix="dryrun_multichip_")
    try:
        args = (world, backend, device, os.path.join(tmp, "rendezvous"),
                job, tmp)
        if world == 1:
            _rank_main(0, *args)
        else:
            torch.multiprocessing.start_processes(
                _rank_main, args=args, nprocs=world, join=True,
                start_method="spawn")
        results = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def dryrun(world: int, backend: str = "nccl", device: str = "cuda",
           mesh: tuple | None = None, nodes: int | None = None,
           groups: int | None = None) -> dict:
    """The dry run: launch, check the gathered cluster, summarise.  Raises
    AssertionError if a group has not exactly one leader or committed
    nothing, or if the ranks disagree on the commit total."""
    mesh = tuple(mesh) if mesh else factor(world)
    job = dryrun_job(mesh, nodes, groups)
    ranks = launch(job, world, backend, device)
    st = ranks[0]["state"]
    roles, commit = st["role"], st["commit"]
    if not ((roles == 3).sum(axis=0) == 1).all():
        raise AssertionError("not exactly one leader per group")
    if not (commit.max(axis=0) > 0).all():
        raise AssertionError("a group committed nothing")
    total = int(commit.max(axis=0).astype(np.int64).sum())
    if {r["committed"] for r in ranks} != {total}:
        raise AssertionError(f"commit totals {[r['committed'] for r in ranks]}"
                             f" != gathered {total}")
    bad = [r["rank"] for r in ranks if r.get("kernel_err", 0)]
    if bad:
        raise AssertionError(f"ranks {bad}: the quorum kernel != its plain "
                             f"version on their last launch's operands")
    return {"platform": "gpu" if device == "cuda" else "cpu",
            "backend": backend, "world": world, "mesh": mesh,
            "n_peers": job["cfg"]["n_peers"], "G": job["cfg"]["n_groups"],
            "ticks": job["ticks"], "committed": total, "ranks": ranks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dryrun_multichip")
    ap.add_argument("--world", type=int, default=1)
    ap.add_argument("--backend", default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None, help="AxB: node x group shards")
    ap.add_argument("--nodes", type=int, default=None)
    ap.add_argument("--groups", type=int, default=None)
    args = ap.parse_args(argv)
    mesh = (tuple(int(x) for x in args.mesh.lower().split("x"))
            if args.mesh else None)
    res = dryrun(args.world, args.backend, args.device, mesh, args.nodes,
                 args.groups)
    for r in res["ranks"]:
        print(f"[rank {r['rank']}] coords {r['coords']}: "
              f"{r['ms_per_tick']:.3f} ms/tick, {r['launches']} kernel "
              f"launches ({r['strided']} strided), local term "
              f"{r['local_term']}, committed {r['committed']}", flush=True)
    a, b = res["mesh"]
    print(f"dryrun_multichip OK: platform={res['platform']}, "
          f"mesh=({a} node x {b} group), G={res['G']}, "
          f"committed={res['committed']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
