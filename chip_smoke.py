"""Drive the PyTorch/H100 port on one card and check it end to end.

    python3 chip_smoke.py [--profile]

Phases (one line printed for each; any failure exits non-zero and prints
no result line):

1. probe   — a CUDA card must be present; prints its name and power limit.
2. build   — nvcc builds the quorum-commit kernel from the sources here.
3. kernel  — the CUDA kernel against its plain PyTorch version on the card,
             bit for bit: P 1..10 at 1, 3, 4, 5, 1000, 1001, 300000 and
             300003 lanes, random voter sets, ~half the lanes joint, an
             empty-mask lane; and the main paths' [3, 100000, 3],
             [5, 100000, 5] and [1, 10000, 3] (with two small shapes)
             dense, transposed (the strided path) and as a view whose
             storage offset breaks 16-byte alignment.  Every path below
             must hand the kernel dense operands: a launch on its
             strided path fails the phase.
4. parity  — the port on CUDA against the port on the CPU: 512 groups,
             P=3 and P=5 with 3 voters, 80 ticks under load with one
             isolate/heal; then the nemesis case: 512 groups x 5 nodes
             with the flight recorder, heat lanes, CheckQuorum and debug
             checks on, chaos_mix(5, 90) plus a 30-tick healthy tail
             through run_cluster_ticks_nemesis.  Every lane of the final
             state (subtrees included), step info and in-flight messages
             must be identical.
5. main    — the bench headline deployment at full size: 100k groups x 3
             nodes (log_slots=64, batch=8, max_submit=8, PreVote), 60
             warm-up ticks, 64 measured ticks through run_cluster_ticks
             with no host synchronisation allowed, a 15-tick drain; one
             leader per group, commits > 0, converged commit indices, and
             exactly one kernel launch per tick.
6. bench   — the benchmark entry points in this process: the child of
             rafting_tpu_torch/tools/bench.py at 100k groups x 3 nodes
             with its default blocking (4 blocks of 25,000 groups through
             run_cluster_ticks_blocked), 32 warm-up and 64 measured ticks,
             the measured window under sync-debug "error": one leader per
             group, commits, one kernel launch per block tick and none on
             the strided path; its reads stage at the same shape (reads
             served); bench_runtime.run at 1,024 groups x 3 RaftNodes for
             5 rounds (commits, per-stage tick means).  Prints each JSON
             line (~90 s).
7. nemesis — BASELINE.json configs[3] at full width: 100k groups x 5
             nodes, all four optional flags on, offered load max_submit,
             a 50-tick healthy warm-up, chaos_mix(5, 150, seed=0), then a
             healthy settle, through
             run_cluster_ticks_nemesis one tick per call with no host
             synchronisation allowed inside a 50-tick audit window.  At
             every window: the port's ClusterChecker, zero debug_viol on
             every tick.  At the end: log matching, one leader per group,
             commits in every group, a CheckQuorum step-down inside the
             split-brain window, one kernel launch per tick.
8. runtime-parity — the node runtime (RaftNode + WAL + loopback +
             LocalCluster, FileMachine per group) on CUDA against the same
             on the CPU: 64 groups x 3 nodes in lockstep through the
             scripted scenario of testkit/lockstep.py (elect, submit
             through leaders, kill the node leading group 0, re-elect,
             submit, restart it from its WAL, drain), with the durable
             pipeline off and then on.  h_role/h_term/h_commit/h_leader
             of every node equal at every round; machine files byte-equal;
             every node's state at the reference's [G] lane shapes.
             Then the same script on two pipelined clusters on the card,
             one whose nodes replay node_step as a CUDA graph (the
             default, runtime/step_graph.py) and one whose nodes run the
             same step uncaptured (capture switched off on each node
             before its first tick): every lane of every
             node's state, step info and outbox equal after every round;
             the replayed nodes replayed and the others captured nothing;
             after every round each node's state is its step's [G] views
             at the reference's shapes, and no step copied a leaf into
             its static state (the script replaces none);
             at the default config and with the flight recorder, heat
             lanes, CheckQuorum and debug checks on.
9. runtime — BASELINE.json configs[2] (10k groups, PreVote, randomized
             leader churn) through three RaftNodes on the card over
             loopback, pipelined, NullProvider, bench_runtime.py's offered
             load (8 x 64-byte payloads per led, ready group per round via
             submit_batch_many): settle, 5 warm-up + 10 measured rounds,
             kill the node leading the most groups, re-elect, restart it
             from its WAL, drain.  One leader per group, converged
             commits, payload agreement and every acknowledged submission
             read back on 512 seeded groups, one kernel launch per node
             tick.
10. api-testnode — BASELINE.json configs[0], the reference's TestNode1-3
             procedure: three `python -m rafting_tpu_torch.tools.noderun`
             processes on the card (XML defaults, three free localhost
             ports), each executing through its own stub every 10 ms; 20 s
             of load, SIGKILL of the leader's process, a restart from its
             data dir, 20 s more, SIGTERM.  Every acknowledged payload is
             in the machine file exactly once, the files are byte-equal up
             to trailing election no-ops, testkit.logcheck finds no
             divergence, the survivors exit 0, and every process held the
             card.
11. api-1k — BASELINE.json configs[1]: 1,000 groups through three
             RaftContainers in this process over localhost TCP, the KV
             machine, PreVote off; waves of two sets and one linearizable
             get per group through the stub on container g mod 3, each
             wave issued in full once every group has a ready leader
             again (failing past 20 node ticks; the rate counts the
             wait).  A set and a get are acknowledged in at
             least 20% of the groups and one forwarded group in every
             measured wave, and over the measured waves in 90% of the
             groups and of the forwarded ones; every
             acknowledged set reads back on all three nodes,
             linz.check passes on 64 sampled groups, no snapshot is taken,
             and every node tick launched the kernel once (a graph replay
             counts its launch).  Each ready wait prints each node's
             ticks and tick p50/max over the wait and over the wave before
             it; a wait that does not begin ready prints, per leader node,
             the led groups not ready and, per peer, those with an RPC
             timeout within recovery_ticks, a fail streak past
             avail_crit, no reply yet, a timeout since the wave began, and
             the groups in a leadership transfer.
12. oracle  — the port's node_step on the card against the scalar oracle
             (testkit/oracle.py) on the host, every state lane, outbound
             message and step-info field at every step, under seeded
             drops, partitions, crash-restarts, clock stalls and
             membership/transfer offers: 1,024 groups x 3 nodes for 60
             ticks (PreVote, lease), then 256 x 5 for 50 with the flight
             recorder, heat lanes, CheckQuorum and debug checks.  One
             kernel launch per node_step call; elections, commits,
             crash-restarts and partitions all happened.
13. snapshot — BASELINE.json configs[4] as tools/validate_config5.py
             drives it: 100k groups x 3 nodes with debug checks, node 2
             isolated while the majority compacts past its tail in every
             group, healed; every group caught up by a floor jump, no
             need_snap on a live leader, one launch per tick.
14. chaos   — rafting_tpu_torch/tools/chaos_run.py on the card, at the
             settings of the JAX package's committed CPU artifacts (the
             isolate and transfer soaks shortened, CHAOS_ISOLATE_ARGS and
             CHAOS_TRANSFER_TICKS; the serial runtime): the
             mixed-nemesis KV soak (linearizable; its timeline equals the
             committed one byte for byte), the stale-read self-test (the
             checker must fail), the leader-isolate gray failure with
             CheckQuorum (goodput back within 60 ticks under the cut, a
             step-down recorded) and one round of the bank transfer soak
             (check_transfer_atomicity); acknowledged writes and reads by
             every client, committed transfers, one launch per node tick.
15. config4 — BASELINE.json configs[3]'s partition scenario through
             rafting_tpu_torch/tools/validate_config4.py's run_config4 at
             100k groups x 5 nodes with debug checks (seed 4): 60 ticks
             under load, one leader per group; the minority {3, 4} cut
             off for up to six windows of 30 ticks (the share of groups
             that progressed on the majority side, beside the reference
             TPU run's 95.7% at 30 and 100% by 120); healed, 75 ticks;
             progress in every group, split brain checked every tick,
             one launch per tick.
16. shard   — the cluster sharded over torch.distributed through
             rafting_tpu_torch/tools/dryrun_multichip.py at 32,768
             groups x 4 nodes, 64 ticks: world 1 over NCCL (mesh 1 x 1,
             in this process) and world 4 over gloo on this card (mesh
             2 node x 2 group, four spawned ranks, collectives staged
             through the host).  Each gathered result equals the
             unsharded run on the card on every lane (the unsharded
             tick loop timed alone, as each rank times its own); every
             rank launched the kernel once a tick, never on its strided
             path, and held it against its plain version on its last
             launch's operands.
17. stages  — the last five stages of rafting_tpu_torch/tools/bench.py
             in this process: the member child at 100k groups (the
             kernel against the fixed-majority baseline at P=3, 32 + 2 x
             64 ticks each; then the P=6 3->3-disjoint walk: learners in,
             catch-up, joint switch, auto-leave, under one submission a
             group a tick), one bench_runtime.run at 1,024 groups with
             the latency and attribution planes pinned on (1/64 span
             sampling, heat lanes, hop tracing) and one with them pinned
             off, 2 rounds each, the open-loop sweep (8 groups, 1 s a
             point, admission on and off) and the 2PC transfer stage (3
             groups, 2 s a phase).  Gates: the walk converged in under
             64 chunks, lost no committed entry and committed again
             after it; one dense launch per tick of the kernel run and
             the walk, none in the fixed run; the kernel equals its
             plain version on the last launch and on a launch inside
             the joint window; the pins took, the heat active set is
             non-empty and hops were traced; the open loop acknowledged
             work with admission on; transfers committed; no strided
             launch.  The member ratio (>= 0.95x fixed) and the
             no-collapse plateau are printed as met or missed, not
             gated: the CLI asserts them, and the planes' 2% budgets.
``--profile`` runs probe, build and kernel, then 8 headline ticks, 32
blocked bench ticks (4 x 25,000 groups, 4 a call) and 8 nemesis ticks
inside the split-brain window under torch.profiler (the top kernels by
device time, the device-busy share, and the kernels next to each
headline qc_kernel, where no copy kernel may be), and stops without the
result line.

The line before the last is the card's name and power limit as nvidia-smi
reports them; before it, one JSON line lists each kernel with its launches
on the path that launched it (the quorum kernel thirteen times: P=3 on the
headline path, P=3 per block of 25,000 groups on the bench path, P=5 on
the nemesis path, P=3 at N=1 per node tick on the
runtime, api-1k and chaos paths, at N=1 per node_step on the oracle path,
P=3 on the snapshot path, P=5 on the config4 path, and P=4 on the shard
path: world 1's [4, 32768, 4] and, from rank 0 of world 4, each rank's
[2, 16384, 4]; P=6 on the member path, its last launch and one inside
the joint window), its error against the plain
version, its
time, the plain version's time and its bound, its device time per launch
(CUDA events, inputs cold in L2), that time's share of the bound, and the
first design's device time on the same inputs.  The
last line is the result object.  ``[time]`` lines give each phase's wall
time and the process's resident memory and threads after it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
INT_OPS_PER_S = 67e12            # vector (non-tensor-core) rate, 32-bit lanes


def log(msg: str) -> None:
    print(msg, flush=True)


def _mem() -> str:
    """This process's resident memory, now (where /proc reports it) and at
    its peak, its mapped memory, and its Python and OS thread counts."""
    import resource
    import threading
    st = {}
    try:
        with open("/proc/self/status") as f:
            st = dict(ln.split(":", 1) for ln in f if ":" in ln)
    except OSError:
        pass

    def gib(key):
        v = st.get(key)
        return f"{int(v.split()[0]) / 2**20:.2f} GiB" if v else "not reported"
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    return (f"rss {gib('VmRSS')} (peak {peak:.2f} GiB), mapped "
            f"{gib('VmSize')}, {threading.active_count()} threads "
            f"({st.get('Threads', '? ').strip()} in the OS)")


def _os_threads() -> int:
    """This process's OS thread count (0 where /proc does not say)."""
    try:
        with open("/proc/self/status") as f:
            for ln in f:
                if ln.startswith("Threads:"):
                    return int(ln.split()[1])
    except OSError:
        pass
    return 0


def _release_host_memory() -> None:
    """Hand freed host memory back before the API phases start their
    thousands of threads: the collector, the CUDA caches (pinned host
    blocks included) and the C heap."""
    import ctypes
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    host_empty = getattr(torch._C, "_host_emptyCache", None)
    if host_empty is not None:
        host_empty()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


# The card's name and power limit as nvidia-smi gives them, once probed:
# printed beside the timings of the phases that measure node ticks.
_CARD = ["(card not probed)"]


def phase_probe() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device — this script runs "
                         "only on the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    log(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count "
        f"{torch.cuda.device_count()} | {card}")
    _CARD[0] = card
    return card


def phase_build() -> None:
    from rafting_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load("quorum_commit")
    info = _build.build_info["quorum_commit"]
    # ptxas -v: each entry's registers and spill bytes, for the kernel at
    # P = 3, 5 and 6 and for the first design it is timed against.
    regs, fn = {}, None
    for ln in info["log"].splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if "'" in ln else ln
        elif fn and ("spill stores" in ln or "registers" in ln):
            regs[fn] = f"{regs.get(fn, '')} {ln.split(':')[-1].strip()}"
    show = [f"{k}: {v}" for k, v in sorted(regs.items())
            if any(t in k for t in ("qc_kernelILi3E", "qc_kernelILi5E",
                                    "qc_kernelILi6E", "qc_kernel_v1ILi3E"))]
    log(f"[build] quorum_commit built in {info['seconds']:.2f}s "
        f"(load {time.perf_counter() - t0:.2f}s); ptxas: "
        f"{' | '.join(show) or info['log'][-400:]}")


def random_case(rng, shape, P, L, dev):
    """The test_ops.py input space: random matches, own_from on both
    sides of the ring, ~70% leading lanes, random non-empty voter sets,
    ~half the lanes joint; lane 0 gets an empty voter mask."""
    base = rng.integers(0, 5, shape)
    last = base + rng.integers(0, L - 5, shape)
    match = rng.integers(0, L, shape + (P,))
    match[..., 0] = last
    commit = np.minimum(rng.integers(0, L, shape), last)
    own_from = rng.integers(0, L + 4, shape)
    lead = rng.random(shape) < 0.7
    full = (1 << P) - 1
    voters = rng.integers(1, full + 1, shape)
    vnew = np.where(rng.random(shape) < 0.5,
                    rng.integers(1, full + 1, shape), 0)
    voters.reshape(-1)[0] = 0
    vnew.reshape(-1)[0] = 0
    lead.reshape(-1)[0] = True
    t = lambda a, dt=torch.int32: torch.as_tensor(
        np.ascontiguousarray(a)).to(dt).to(dev)
    return (t(match), t(own_from), t(last), t(commit),
            t(lead, torch.bool), t(voters), t(vnew))


KERNEL_LANES = (1, 3, 4, 5, 1000, 1001, 300_000, 300_003)


def laid_out(t: torch.Tensor, layout: str) -> torch.Tensor:
    """``t`` stored dense, transposed (every axis reversed in memory, as
    the step's inbox lanes come) or one element past a 16-byte boundary
    (a view with a storage offset)."""
    if layout == "transposed":
        rev = tuple(range(t.dim() - 1, -1, -1))
        return t.permute(rev).contiguous().permute(rev)
    if layout == "offset":
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    return t


def phase_kernel() -> None:
    from rafting_tpu_torch.ops.quorum import (
        quorum_commit_cuda, quorum_commit_ref,
    )
    rng = np.random.default_rng(1234)
    n = 0
    cases = [(P, (G,), "dense") for P in range(1, 11)
             for G in KERNEL_LANES]
    cases += [(P, shape, layout) for P, shape in (
        (3, (3, 100_000)), (5, (5, 100_000)), (3, (1, 10_000)),
        (7, (3, 1001)), (10, (2, 3)))
        for layout in ("dense", "transposed", "offset")]
    for P, shape, layout in cases:
        args = tuple(laid_out(a, layout)
                     for a in random_case(rng, shape, P, 64, "cuda"))
        got = quorum_commit_cuda(*args)
        ref = quorum_commit_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            cpu = quorum_commit_ref(*(a.cpu() for a in args))
            bad = (got != ref).reshape(-1).nonzero()[:3, 0].tolist()
            flat = [a.reshape(-1, *a.shape[len(shape):]).cpu()
                    for a in args]
            rows = [(i, [f[i].tolist() for f in flat], int(got.reshape(-1)[i]),
                     int(ref.reshape(-1)[i]), int(cpu.reshape(-1)[i]))
                    for i in bad]
            raise AssertionError(
                f"kernel != plain at P={P} shape={shape} {layout}: (lane, "
                f"[match, own_from, last, commit, can_lead, voters, "
                f"voters_new], kernel, plain on card, plain on cpu) {rows}")
        n += 1
    log(f"[kernel] quorum_commit == quorum_commit_ref bit for bit in {n} "
        f"cases (P 1..10 at {len(KERNEL_LANES)} lane counts up to 300003; "
        f"[3, 100000, 3], [5, 100000, 5] and three more shapes dense, "
        f"transposed and at a misaligned storage offset; joint and "
        f"empty-mask lanes)")


def _compare(a, b, path: str) -> None:
    from rafting_tpu_torch.core.types import _Tree
    if isinstance(a, _Tree):
        for f in dataclasses.fields(a):
            _compare(getattr(a, f.name), getattr(b, f.name),
                     f"{path}.{f.name}")
        return
    if a is None or b is None:
        assert a is None and b is None, path
        return
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
        raise AssertionError(f"CUDA != CPU at {path}")


def phase_parity() -> None:
    from rafting_tpu_torch import DeviceCluster, EngineConfig
    from rafting_tpu_torch.ops import quorum
    for P, nv in ((3, None), (5, 3)):
        quorum.reset_launch_counts()
        cfg = EngineConfig(n_groups=512, n_peers=P, log_slots=64, batch=8,
                           max_submit=8)
        cl = {d: DeviceCluster(cfg, seed=11, n_voters=nv, device=d)
              for d in ("cuda", "cpu")}
        for t in range(80):
            for c in cl.values():
                if t == 30:
                    c.isolate(0)
                if t == 55:
                    c.heal()
                c.tick(submit_n=2)
        if _launches("parity") != 80:
            raise AssertionError("[parity] want one launch per CUDA tick")
        a, b = cl["cuda"], cl["cpu"]
        _compare(a.states, b.states, "state")
        _compare(a.last_info, b.last_info, "info")
        _compare(a.inflight, b.inflight, "inflight")
        commits = int(a.states.commit.amax(dim=0).sum())
        log(f"[parity] P={P} n_voters={nv or P}: port on CUDA == port on "
            f"CPU on every lane after 80 ticks (commit sum {commits})")


def phase_parity_nemesis() -> None:
    from rafting_tpu_torch import (
        DeviceCluster, EngineConfig, run_cluster_ticks_nemesis,
    )
    from rafting_tpu_torch.core.types import tree_map
    from rafting_tpu_torch.ops import quorum
    from rafting_tpu_torch.testkit import nemesis
    cfg = EngineConfig(n_groups=512, n_peers=5, log_slots=64, batch=8,
                       max_submit=8, trace_depth=16, heat=True,
                       check_quorum=True, debug_checks=True)
    sched = nemesis.concat(nemesis.chaos_mix(5, 90, seed=13, device="cpu"),
                           nemesis.healthy(5, 30, device="cpu"))
    out = {}
    quorum.reset_launch_counts()
    for d in ("cuda", "cpu"):
        c = DeviceCluster(cfg, seed=13, device=d)
        load = torch.full((5, cfg.n_groups), 4, dtype=torch.int32,
                          device=d)
        out[d] = run_cluster_ticks_nemesis(
            cfg, c.states, c.inflight, c.last_info,
            tree_map(lambda a: a.to(d), sched), load, device=d)
    if _launches("parity-nemesis") != sched.n_ticks:
        raise AssertionError("[parity-nemesis] want one launch per CUDA "
                             "tick")
    for name, a, b in zip(("state", "inflight", "info"), out["cuda"],
                          out["cpu"]):
        _compare(a, b, name)
    s = out["cpu"][0]
    log(f"[parity] nemesis P=5, trace/heat/check_quorum/debug_checks on, "
        f"{sched.n_ticks} ticks: port on CUDA == port on CPU on every lane "
        f"(commit sum {int(s.commit.amax(dim=0).sum())}, trace events "
        f"{int(s.trace.n.sum())}, heat rpcs {int(s.heat.sent.sum())})")


def _time_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _device_us(fn, reps: int = 100) -> float:
    """Device time of one launch of ``fn``'s kernel, in µs, with its
    inputs cold in L2: CUDA events around ``reps`` launches, each after a
    64 MiB write that evicts the 50 MB L2, less the same writes alone.
    A spin kernel first keeps the device busy while the host queues them
    all, so the launches run back to back and the host's launch cost is
    not counted."""
    flush = torch.empty(1 << 26, dtype=torch.uint8, device="cuda")
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)

    def per_launch_us(body) -> float:
        body()
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)       # ~50 ms at the H100's clock
        e0.record()
        for _ in range(reps):
            body()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) * 1e3 / reps

    def both():
        flush.zero_()
        fn()
    return per_launch_us(both) - per_launch_us(flush.zero_)


def _launch_v1(args) -> torch.Tensor:
    """The first design of the kernel (one thread a lane, scalar loads),
    kept in the .cu for timing only, on contiguous copies of ``args``."""
    from rafting_tpu_torch.ops import _build, quorum
    out = torch.empty(args[0].shape[:-1], dtype=torch.int32, device="cuda")
    quorum._launch(_build.load("quorum_commit").qc_launch_v1,
                   torch.cuda.current_stream().cuda_stream, out, *args)
    return out


# The operands of the quorum kernel's last CUDA launch, as phase 10 of the
# tick passed them (strides included): _kernel_entry times the kernel on
# these, so the timed layout is the one the path launched.
_TICK_OPERANDS = [None]


def _capture_tick_operands() -> None:
    """Wrap phase 10's call to keep each CUDA launch's operands."""
    import rafting_tpu_torch.core.step as step
    real = step.quorum_commit

    def quorum_commit(cfg, match_full, log, commit, own_from, can_lead,
                      voters, voters_new):
        if match_full.is_cuda:
            _TICK_OPERANDS[0] = (match_full, own_from, log.last, commit,
                                 can_lead, voters, voters_new)
        return real(cfg, match_full, log, commit, own_from, can_lead,
                    voters, voters_new)
    step.quorum_commit = quorum_commit


def _launches(where: str) -> int:
    """The quorum kernel's launches since the counts were reset.  Fails if
    any took the kernel's strided path: the tick hands it dense
    operands."""
    from rafting_tpu_torch.ops import quorum
    n = quorum.launch_counts["quorum_commit"]
    strided = quorum.strided_launches["quorum_commit"]
    if strided:
        raise AssertionError(f"[{where}] {strided} of {n} quorum kernel "
                             f"launches took the strided path")
    return n


def _kernel_entry(name: str, launches: int) -> dict:
    """The quorum kernel at a path's own shapes — the operands of the
    path's last launch, as its tick passed them — against its plain
    version, timed, with its bound, its device time per launch and the
    first design's on the same inputs.  These launches are not counted as
    the path's."""
    from rafting_tpu_torch.ops import quorum

    args, _TICK_OPERANDS[0] = _TICK_OPERANDS[0], None
    if args is None:
        raise AssertionError(f"{name}: the path launched no kernel")
    if args[0].dim() == 2:       # one node's [G, P]: a view, as the wrapper
        args = tuple(a.unsqueeze(0) for a in args)
    got = quorum.quorum_commit_cuda(*args)
    ref = quorum.quorum_commit_ref(*args)
    err = int((got.long() - ref.long()).abs().max())
    ms = _time_ms(lambda: quorum.quorum_commit_cuda(*args), 200)
    plain_ms = _time_ms(lambda: quorum.quorum_commit_ref(*args), 50)
    device_us = _device_us(lambda: quorum.quorum_commit_cuda(*args))
    dense = tuple(a.contiguous() for a in args)
    if not torch.equal(_launch_v1(dense), ref):
        raise AssertionError(f"{name}: the first design != plain")
    v1_us = _device_us(lambda: _launch_v1(dense))
    nbytes = sum(a.numel() * a.element_size() for a in args) + \
        got.numel() * got.element_size()
    P = args[0].shape[-1]
    # Per lane: two masked sorting networks (P rounds of ~P-1 min/max
    # pairs), the full-lane min and the gates — ~4*P*P + 8*P + 16 ops.
    ops = got.numel() * (4 * P * P + 8 * P + 16)
    bound_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ops = ops / INT_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes, bound_ops)
    if err != 0:
        raise AssertionError(f"{name}: kernel != plain on the path's inputs "
                             f"(max abs err {err})")
    return {"name": name, "route": "cuda",
            "source": "rafting_tpu_torch/ops/csrc/quorum_commit.cu",
            "replaces": "rafting_tpu/ops/quorum.py:231",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
            "library_ms": None, "bytes": nbytes, "device_us": device_us,
            "share_of_bound": bound_ms * 1e3 / device_us,
            "v1_device_us": v1_us, "shape": list(args[0].shape)}


def _kernel_line(k: dict) -> str:
    return (f"{k['ms'] * 1e3:.2f} us/launch (device {k['device_us']:.2f} us"
            f", {k['share_of_bound']:.0%} of the bound; first design "
            f"{k['v1_device_us']:.2f} us; plain {k['plain_ms'] * 1e3:.2f} us,"
            f" bound {k['bound_ms'] * 1e3:.2f} us, {k['bytes']} bytes, "
            f"shape {k['shape']})")


def phase_main() -> dict:
    from rafting_tpu_torch import (
        LEADER, DeviceCluster, EngineConfig, committed_entries,
        run_cluster_ticks,
    )
    from rafting_tpu_torch.ops import quorum

    cfg = EngineConfig(n_groups=100_000, n_peers=3, log_slots=64, batch=8,
                       max_submit=8, election_ticks=10, heartbeat_ticks=3,
                       rpc_timeout_ticks=8, pre_vote=True)
    N, G = cfg.n_peers, cfg.n_groups
    torch.cuda.reset_peak_memory_stats()
    c = DeviceCluster(cfg, seed=0, device="cuda")
    load = torch.full((N, G), cfg.max_submit, dtype=torch.int32,
                      device="cuda")
    run = lambda k, sub: run_cluster_ticks(
        cfg, k, c.states, c.inflight, c.last_info, c.conn, sub,
        device="cuda")

    c.states, c.inflight, c.last_info = run(60, load)
    torch.cuda.synchronize()
    before = int(committed_entries(c.states))

    T = 64
    quorum.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.perf_counter()
    c.states, c.inflight, c.last_info = run(T, load)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _launches("main")
    after = int(committed_entries(c.states))
    if launches != T:
        raise AssertionError(f"quorum kernel launched {launches} times in "
                             f"{T} ticks (want one per tick)")

    idle = torch.zeros((N, G), dtype=torch.int32, device="cuda")
    c.states, c.inflight, c.last_info = run(15, idle)
    snap = c.snapshot()
    n_lead = (snap["role"] == LEADER).sum(axis=0)
    if not (n_lead == 1).all():
        raise AssertionError(f"{int((n_lead != 1).sum())} groups without "
                             f"exactly one leader")
    if not (snap["commit"] > 0).all():
        raise AssertionError("a group committed nothing")
    if not (snap["commit"] == snap["commit"][0:1]).all():
        raise AssertionError("commit indices differ across nodes after "
                             "the drain")
    peak = torch.cuda.max_memory_allocated()

    kern = _kernel_entry("quorum_commit", launches)
    commits = after - before
    log(f"[main] 100000 groups x 3 nodes: {commits} commits in {T} ticks, "
        f"{commits / secs:.0f} commits/s, {secs / T * 1e3:.3f} ms/tick; "
        f"quorum_commit {launches} launches, {_kernel_line(kern)}; "
        f"peak memory {peak / 2**30:.3f} GiB; "
        f"leaders {int(n_lead.sum())}, commit min {int(snap['commit'].min())}")
    return kern


# [bench]: the benchmark entry points (rafting_tpu_torch/tools/bench.py and
# bench_runtime.py) in this process, at bench.py's 100k headline shape with
# its default blocking, shortened to BENCH_TICKS.
BENCH_GROUPS = 100_000
BENCH_BLOCKS = (4, 25_000)       # bench.py's rule above 32,768 groups
BENCH_TICKS = (32, 64)           # warm-up, measured
BENCH_RT_GROUPS = 1024


def phase_bench() -> dict:
    from rafting_tpu_torch.ops import quorum
    from rafting_tpu_torch.tools import bench, bench_runtime

    G, (warm, T) = BENCH_GROUPS, BENCH_TICKS
    # (a) The ladder's child at 100k: every tick of it runs the blocked
    # loop, and its measured window runs under sync-debug "error".
    quorum.reset_launch_counts()
    res = bench.child_run(G, T, warm)
    launches = _launches("bench")
    blocks = (res["n_blocks"], res["group_block"])
    if blocks != BENCH_BLOCKS:
        raise AssertionError(f"[bench] {G} groups ran as {blocks} (blocks, "
                             f"groups a block), want {BENCH_BLOCKS}")
    if launches != (warm + T) * blocks[0]:
        raise AssertionError(f"[bench] quorum kernel launched {launches} "
                             f"times in {warm + T} ticks x {blocks[0]} "
                             f"blocks (want one per block tick)")
    kern = _kernel_entry("quorum_commit[bench]", launches)
    log(f"[bench] {json.dumps(res)}")
    log(f"[bench] {json.dumps(bench.headline(res))}")
    log(f"[bench] child {G} groups in {blocks[0]} blocks of {blocks[1]}: "
        f"{res['commits']} commits in {T} ticks, one leader per group, "
        f"{res['elapsed_s'] / T * 1e3:.3f} ms/tick; quorum_commit "
        f"{launches} launches ({warm + T} ticks x {blocks[0]} blocks), "
        f"{_kernel_line(kern)}")

    # (b) The reads stage at the same shape: a blocked warm-up, then the
    # unblocked reads loop (as bench.py runs it).
    os.environ["BENCH_READS"] = "1"
    try:
        quorum.reset_launch_counts()
        rd = bench.child_run(G, T, warm)
    finally:
        del os.environ["BENCH_READS"]
    rd_launches = _launches("bench-reads")
    chunk = max(16, 128 // blocks[0])
    warm_steps = sorted({min(chunk, T - d) for d in range(0, T, chunk)})
    want = warm * blocks[0] + sum(warm_steps) + T
    if rd_launches != want or not rd["reads"] > 0:
        raise AssertionError(f"[bench] reads stage: {rd['reads']} reads "
                             f"served, {rd_launches} launches (want > 0 "
                             f"reads and {want} launches)")
    log(f"[bench] {json.dumps(bench.headline_reads(rd))}")
    log(f"[bench] reads: {rd['reads']} served ({rd['lease_hits']} lease "
        f"hits, {rd['appended']} entries appended) in {T} ticks, "
        f"{rd['rps']:.0f} reads/s; quorum_commit {rd_launches} launches")

    # (c) The durable runtime through bench_runtime.run on the card.
    quorum.reset_launch_counts()
    rt = bench_runtime.run(n_groups=BENCH_RT_GROUPS, rounds=5,
                           device="cuda")
    rt_launches = _launches("bench-runtime")
    if not rt["value"] > 0 or rt_launches == 0:
        raise AssertionError(f"[bench] bench_runtime: {rt['value']} "
                             f"commits/s, {rt_launches} kernel launches")
    log(f"[bench] {json.dumps(rt)}")
    log(f"[bench] bench_runtime {BENCH_RT_GROUPS} groups x 3 RaftNodes "
        f"(pipeline {rt['pipeline']}): {rt['value']} durable commits/s; "
        f"slowest node's stage means (s) {rt['tick_stages_mean_s']}; "
        f"quorum_commit {rt_launches} launches")
    return kern


# The nemesis phase's healthy settle after chaos_mix.  The per-group
# election lottery has a slow tail: at 100k groups x 5 nodes every group
# had one leader again within 50 settle ticks (H100; PERF.md §4), and 200
# leaves four times that.
NEMESIS_SETTLE = 200


def nemesis_cfg():
    """BASELINE.json configs[3] (100k groups, 5 peers, AppendEntries +
    RequestVote under partition) with every optional subtree on."""
    from rafting_tpu_torch import EngineConfig
    return EngineConfig(n_groups=100_000, n_peers=5, log_slots=64, batch=8,
                        max_submit=8, election_ticks=10, heartbeat_ticks=3,
                        rpc_timeout_ticks=8, pre_vote=True, trace_depth=16,
                        heat=True, check_quorum=True, debug_checks=True)


def phase_nemesis() -> dict:
    from rafting_tpu_torch import (
        LEADER, DeviceCluster, committed_entries, raise_debug_violations,
        run_cluster_ticks_nemesis,
    )
    from rafting_tpu_torch.core.types import tree_map
    from rafting_tpu_torch.ops import quorum
    from rafting_tpu_torch.testkit import nemesis
    from rafting_tpu_torch.testkit.invariants import (
        ClusterChecker, cluster_snapshot,
    )

    cfg = nemesis_cfg()
    N, G, dev = cfg.n_peers, cfg.n_groups, "cuda"
    # A healthy warm-up first: the split brain must cut leaders off, or
    # CheckQuorum has no leader on the minority side to depose.
    WARM, CHAOS, WINDOW = 50, 150, 50
    t3 = CHAOS // 3
    split = range(WARM + t3 // 4, WARM + 3 * t3 // 4)  # split-brain ticks
    sched = nemesis.concat(nemesis.healthy(N, WARM, dev),
                           nemesis.chaos_mix(N, CHAOS, seed=0, device=dev),
                           nemesis.healthy(N, NEMESIS_SETTLE, dev))
    T = sched.n_ticks
    crash_np = sched.crash.cpu().numpy()

    torch.cuda.reset_peak_memory_stats()
    c = DeviceCluster(cfg, seed=0, device=dev)
    states, inflight, info = c.states, c.inflight, c.last_info
    load = torch.full((N, G), cfg.max_submit, dtype=torch.int32, device=dev)
    chk = ClusterChecker(cfg)
    chk.check(cluster_snapshot(states))
    zero = lambda: torch.zeros((), dtype=torch.int64, device=dev)
    downs, split_downs, viol = zero(), zero(), zero()
    run_s = chaos_s = audit_s = 0.0
    chaos_commits = committed = 0
    quorum.reset_launch_counts()
    for lo in range(0, T, WINDOW):
        hi = min(lo + WINDOW, T)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        for t in range(lo, hi):
            states, inflight, info = run_cluster_ticks_nemesis(
                cfg, states, inflight, info,
                tree_map(lambda a: a[t:t + 1], sched), load, device=dev)
            d = info.cq_stepdown.sum()
            downs += d
            if t in split:
                split_downs += d
            viol += (info.debug_viol != 0).sum()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        run_s += secs
        t0 = time.perf_counter()
        snap = cluster_snapshot(states)
        chk.check(snap, crashed=crash_np[lo:hi].any(axis=0))
        raise_debug_violations(info, f"nemesis ticks {lo}..{hi}")
        if int(viol):
            raise AssertionError(f"{int(viol)} lanes reported a debug_viol "
                                 f"code by tick {hi}")
        audit_s += time.perf_counter() - t0
        before, committed = committed, int(committed_entries(states))
        n_lead = (snap["role"] == LEADER).sum(axis=0)
        if WARM <= lo and hi <= WARM + CHAOS:
            chaos_s += secs
            chaos_commits += committed - before
        log(f"[nemesis] ticks {lo:4d}..{hi:4d}: {secs / (hi - lo) * 1e3:.3f} "
            f"ms/tick, committed {committed}, groups without exactly one "
            f"leader {int((n_lead != 1).sum())}, step-downs so far "
            f"{int(downs)}")
    launches = _launches("nemesis")
    if launches != T:
        raise AssertionError(f"quorum kernel launched {launches} times in "
                             f"{T} nemesis ticks (want one per tick)")
    t0 = time.perf_counter()
    chk.check_log_matching(snap)
    audit_s += time.perf_counter() - t0
    n_lead = (snap["role"] == LEADER).sum(axis=0)
    if not (n_lead == 1).all():
        raise AssertionError(f"{int((n_lead != 1).sum())} groups without "
                             f"exactly one leader after {NEMESIS_SETTLE} "
                             f"settle ticks")
    if not (snap["commit"].max(axis=0) > 0).all():
        raise AssertionError("a group committed nothing under the nemesis")
    if int(split_downs) == 0:
        raise AssertionError("no CheckQuorum step-down in the split-brain "
                             f"window (ticks {split.start}..{split.stop})")
    peak = torch.cuda.max_memory_allocated()
    kern = _kernel_entry("quorum_commit[P=5 nemesis]", launches)
    log(f"[nemesis] {G} groups x {N} nodes, trace/heat/check_quorum/"
        f"debug_checks on, {WARM} warm-up + {CHAOS} chaos + "
        f"{NEMESIS_SETTLE} settle ticks: "
        f"{run_s / T * 1e3:.3f} ms/tick overall, {chaos_s / CHAOS * 1e3:.3f} "
        f"ms/tick and {chaos_commits / chaos_s:.0f} commits/s under faults "
        f"({chaos_commits} commits in {CHAOS} ticks); audits {audit_s:.2f}s; "
        f"CheckQuorum step-downs {int(downs)} ({int(split_downs)} in the "
        f"split-brain window); trace events {int(states.trace.n.sum())}; "
        f"heat rpcs {int(states.heat.sent.sum())}; peak memory "
        f"{peak / 2**30:.3f} GiB; leaders {int(n_lead.sum())}; "
        f"quorum_commit {launches} launches, {_kernel_line(kern)}")
    return kern


def _state_table(cfg) -> dict:
    """path -> (shape, dtype) of every leaf of one node's engine state at
    ``[G]`` lanes for ``cfg``: ``init_state``'s, the shapes of the
    reference's ``RaftNode.state`` (the port's CPU tests hold the two
    equal leaf for leaf)."""
    from rafting_tpu_torch.core.types import init_state
    return _leaf_shapes(init_state(cfg, 0, device="cpu"))


def _leaf_shapes(tree, path="state") -> dict:
    out = {}
    for f in dataclasses.fields(tree):
        v, where = getattr(tree, f.name), f"{path}.{f.name}"
        if dataclasses.is_dataclass(v):
            out.update(_leaf_shapes(v, where))
        else:
            out[where] = None if v is None else (tuple(v.shape), v.dtype)
    return out


def _check_state_shapes(cluster, table: dict, where: str) -> int:
    """Hold every live node's ``state`` to ``table``; the nodes checked."""
    for i, n in sorted(cluster.nodes.items()):
        got = _leaf_shapes(n.state)
        if got != table:
            bad = sorted(k for k in table if got.get(k) != table[k])
            raise AssertionError(
                f"{where}: node {i}'s state leaves differ from the "
                f"reference's [G] shapes: " + "; ".join(
                    f"{k} {got.get(k)} vs {table[k]}" for k in bad[:4]))
    return len(cluster.nodes)


def phase_runtime_parity() -> None:
    import tempfile
    from rafting_tpu_torch import EngineConfig, LocalCluster
    from rafting_tpu_torch.testkit.lockstep import pinned_env, run_script
    cfg = EngineConfig(n_groups=64, n_peers=3, log_slots=32, batch=4,
                       max_submit=4, election_ticks=10, heartbeat_ticks=3,
                       rpc_timeout_ticks=8)
    table = _state_table(cfg)
    for pipeline in (False, True):
        with tempfile.TemporaryDirectory() as root, pinned_env():
            t0 = time.perf_counter()
            cl = [LocalCluster(cfg, os.path.join(root, d), pipeline=pipeline,
                               device=d) for d in ("cuda", "cpu")]
            try:
                r = run_script(cl)
                for c, d in zip(cl, ("cuda", "cpu")):
                    _check_state_shapes(c, table, f"pipeline={pipeline} {d}")
            finally:
                for c in cl:
                    c.close()
        log(f"[runtime-parity] pipeline={pipeline}: 64 groups x 3 RaftNodes "
            f"on CUDA == on CPU at every one of {r['rounds']} rounds "
            f"(killed node {r['victim']}, {len(r['acked'])} acknowledged "
            f"submissions), machine files byte-equal "
            f"({sum(len(b) for b in r['files'].values())} bytes); every "
            f"node's state at the reference's [G] shapes ({len(table)} "
            f"leaves); {time.perf_counter() - t0:.1f}s")
    # The node's step replayed as a CUDA graph (the card's default,
    # runtime/step_graph.py) against the same step run uncaptured (each
    # node's capture switched off before its first tick), both on the
    # card and pipelined: every lane of
    # every node's state, step info and outbox equal after every round,
    # through the script's election, submissions, leader kill (a leader
    # change in every group it led) and restart; at the default config
    # and with every optional subtree of the step on.
    full = dataclasses.replace(cfg, trace_depth=16, heat=True,
                               check_quorum=True, debug_checks=True)
    for label, c_cfg in (("default", cfg), ("subtrees on", full)):
        _graph_parity(label, c_cfg)


def _graph_parity(label: str, cfg) -> None:
    import tempfile
    from rafting_tpu_torch import LocalCluster
    from rafting_tpu_torch.testkit.lockstep import pinned_env, run_script
    table = _state_table(cfg)
    checked = [0]
    with tempfile.TemporaryDirectory() as root, pinned_env():
        t0 = time.perf_counter()
        cl = [LocalCluster(cfg, os.path.join(root, d), device="cuda")
              for d in ("eager", "graph")]
        for n in cl[0].nodes.values():
            n._stepper.capture = False
        steppers = [[n._stepper for n in c.nodes.values()] for c in cl]
        spent = [0.0, 0.0]
        for k, c in enumerate(cl):
            def start_node(i, real=c.start_node, k=k):
                n = real(i)
                if k == 0:
                    n._stepper.capture = False
                steppers[k].append(n._stepper)
                return n

            def tick(rounds=1, real=c.tick, k=k, c=c):
                t = time.perf_counter()
                real(rounds)
                spent[k] += time.perf_counter() - t
                # The [G] shapes, and the node holding the step's views.
                checked[0] += _check_state_shapes(c, table, label)
                if any(n.state is not n._stepper.state
                       for n in c.nodes.values()):
                    raise AssertionError(f"{label}: a node's state is not "
                                         f"its step's views")
            c.start_node, c.tick = start_node, tick
        try:
            r = run_script(cl, lanes=True)
        finally:
            for c in cl:
                c.close()
    caps = [sum(st.captures for st in ss) for ss in steppers]
    reps = [sum(st.replays for st in ss) for ss in steppers]
    if any(st._layouts or st.state is not None or st._static is not None
           for ss in steppers for st in ss):
        raise AssertionError("a closed node still holds its step's graphs "
                             "or buffers")
    replay_s = sum(st.replay_s for st in steppers[1])
    # The script replaces no lane of any node (no lifecycle write, no
    # purge), so after each node's first step _adopt copies nothing.
    copied = [sum(st.copied for st in ss) for ss in steppers]
    if any(copied):
        raise AssertionError(f"{label}: _adopt copied {copied} static "
                             f"leaves (uncaptured, replayed) on ticks where "
                             f"no node replaced a lane")
    if caps[0] or reps[0] or any(st.capture for st in steppers[0]):
        raise AssertionError(f"the uncaptured cluster captured {caps[0]} "
                             f"graphs and replayed {reps[0]} ticks")
    if not all(st.capture for st in steppers[1]) or \
            reps[1] < 3 * r["rounds"] // 2:
        raise AssertionError(f"the replayed cluster replayed {reps[1]} "
                             f"node ticks in {r['rounds']} rounds")
    log(f"[runtime-parity] CUDA graph, {label}: node_step replayed "
        f"({caps[1]} graphs captured by {len(steppers[1])} nodes, "
        f"{reps[1]} replays) == uncaptured, on every lane of every node's "
        f"state, step info and outbox at every one of {r['rounds']} "
        f"rounds (killed node {r['victim']}, {len(r['acked'])} "
        f"acknowledged submissions); every node's state at the "
        f"reference's [G] shapes ({len(table)} leaves) and the step's own "
        f"views after every round ({checked[0]} node checks); _adopt "
        f"copied {copied[0]} + {copied[1]} static leaves after the first "
        f"steps; a round of three node ticks took "
        f"{spent[0] / r['rounds'] * 1e3:.1f} ms uncaptured, "
        f"{spent[1] / r['rounds'] * 1e3:.1f} ms replayed, of which "
        f"{replay_s / max(reps[1], 1) * 1e3:.3f} ms of host time per "
        f"replay call, on {_CARD[0]}; {time.perf_counter() - t0:.1f}s")


# BASELINE.json configs[2] driven as bench_runtime.py drives its 10k-group
# scale (_shape: 8 entries per led group per round, 512 log slots; batch
# and max_submit 32).  Its 25 measured rounds are cut to 10: a round took
# 6.6 s on the H100 machine's host, and the phase must leave the script
# inside its time limit (PERF.md §4).
RUNTIME_GROUPS = 10_000
RUNTIME_WARMUP, RUNTIME_ROUNDS, RUNTIME_BURST = 5, 10, 8
RUNTIME_SAMPLE = 512


class _PayloadAudit:
    """Reads the committed payloads of a seeded sample of groups from
    every node's LogStore after each round (compaction keeps the newest
    committed entries, so nothing is missed between two reads), and the
    indices of every acknowledged submission in the sample.  ``seconds``
    is the time spent reading, which the round timing leaves out."""

    def __init__(self, G: int, n: int, seed: int = 0):
        self.groups = np.sort(np.random.default_rng(seed).choice(
            G, n, replace=False)).tolist()
        self.sample = set(self.groups)
        self.read: dict = {}        # (node, group) -> {index: payload}
        self.upto: dict = {}        # (node, group) -> last index read
        self.sinks: list = []       # (group, payloads, sink)
        self.seconds = 0.0

    def offer(self, node, led: np.ndarray, burst: list) -> None:
        sinks = node.submit_batch_many(led, burst)
        for g, sink in zip(led.tolist(), sinks):
            if g in self.sample:
                self.sinks.append((g, burst, sink))

    def collect(self, nodes) -> None:
        t0 = time.perf_counter()
        for i, n in nodes.items():
            for g in self.groups:
                got = self.read.setdefault((i, g), {})
                lo = max(self.upto.get((i, g), 0), n.store.floor(g)) + 1
                hi = min(int(n.h_commit[g]), n.store.tail(g))
                if hi < lo:
                    continue
                for k, p in enumerate(n.store.payloads_window(
                        g, lo, hi - lo + 1)):
                    if p is None:
                        break
                    got[lo + k] = p
                    self.upto[(i, g)] = lo + k
        self.seconds += time.perf_counter() - t0

    def check(self, node_ids) -> tuple:
        """Agreement on every index two nodes both read; every
        acknowledged submission read back from a majority of the nodes,
        and from every node that read its index.  Returns (acknowledged,
        read back from all nodes)."""
        for g in self.groups:
            have = [self.read.get((i, g), {}) for i in node_ids]
            for a in have:
                for b in have:
                    for idx in a.keys() & b.keys():
                        if a[idx] != b[idx]:
                            raise AssertionError(
                                f"group {g} index {idx}: replicas disagree")
        acked = everywhere = 0
        for g, burst, sink in self.sinks:
            f = sink.future
            if not f.done() or f.exception() is not None:
                continue
            for idx, p in zip(f.result(), burst):
                acked += 1
                found = [self.read.get((i, g), {}).get(idx)
                         for i in node_ids]
                hits = [x for x in found if x is not None]
                if any(x != p for x in hits) or \
                        2 * len(hits) <= len(node_ids):
                    raise AssertionError(
                        f"acknowledged submission lost: group {g} index "
                        f"{idx} read back on {len(hits)} node(s)")
                everywhere += len(hits) == len(node_ids)
        return acked, everywhere


def phase_runtime() -> dict:
    import tempfile
    from rafting_tpu_torch import LEADER, EngineConfig, LocalCluster
    from rafting_tpu_torch.log.wal import native_available
    from rafting_tpu_torch.ops import quorum
    from rafting_tpu_torch.testkit.fixtures import NullProvider

    cfg = EngineConfig(n_groups=RUNTIME_GROUPS, n_peers=3, log_slots=512,
                       batch=32, max_submit=32, election_ticks=10,
                       heartbeat_ticks=3, rpc_timeout_ticks=8, pre_vote=True)
    G = cfg.n_groups
    audit = _PayloadAudit(G, RUNTIME_SAMPLE)
    ticks = 0

    def tick_round():
        nonlocal ticks
        for n in c.nodes.values():
            n.tick()
        ticks += len(c.nodes)
        audit.collect(c.nodes)

    def leaders():
        return (np.stack([n.h_role for n in c.nodes.values()])
                == LEADER).sum(axis=0)

    def offer(r):
        burst = [f"r{r:04d}-{j:02d}-".encode().ljust(64, b"x")
                 for j in range(RUNTIME_BURST)]
        for n in c.nodes.values():
            audit.offer(n, np.nonzero((n.h_role == LEADER) & n.h_ready)[0],
                        burst)

    def mean_commits():
        return sum(int(n.h_commit.astype(np.int64).sum())
                   for n in c.nodes.values()) / len(c.nodes)

    root = tempfile.mkdtemp(prefix="runtime-")
    torch.cuda.reset_peak_memory_stats()
    quorum.reset_launch_counts()
    t_boot = time.perf_counter()
    c = LocalCluster(cfg, root, provider_factory=NullProvider, seed=0,
                     device="cuda")
    try:
        node0 = c.nodes[0]
        if not node0.pipeline:
            raise AssertionError("the durable pipeline is off on the card")
        settle = 0
        while not (leaders() >= 1).all():
            tick_round()
            settle += 1
            if settle > 300:
                raise AssertionError(f"{int((leaders() == 0).sum())} "
                                     f"groups without a leader after "
                                     f"{settle} rounds")
        settle_s = time.perf_counter() - t_boot
        r = 0
        for _ in range(RUNTIME_WARMUP):
            offer(r)
            tick_round()
            r += 1
        for n in c.nodes.values():
            n.metrics.histogram("tick_latency_s").reset()
            for stage in n.metrics.breakdown():
                n.metrics.histogram(f"tick_stage_{stage}").reset()
        start = mean_commits()
        l0, t_meas = quorum.launch_counts["quorum_commit"], ticks
        torch.cuda.synchronize()
        a0, t0 = audit.seconds, time.perf_counter()
        for _ in range(RUNTIME_ROUNDS):
            offer(r)
            tick_round()
            r += 1
        elapsed = time.perf_counter() - t0 - (audit.seconds - a0)
        commits = mean_commits() - start
        meas_launches = quorum.launch_counts["quorum_commit"] - l0
        meas_ticks = ticks - t_meas
        slow = max(c.nodes.values(),
                   key=lambda n: n.metrics.histogram("tick_latency_s").total)
        h = slow.metrics.histogram("tick_latency_s")
        p50, p99, mean, top = (h.quantile(0.5), h.quantile(0.99),
                               h.total / max(h.n, 1), h.max)
        stages = {k: v["mean"] for k, v in slow.metrics.breakdown().items()}

        # Leader churn: the node leading the most groups dies.
        led = {i: int((n.h_role == LEADER).sum()) for i, n in c.nodes.items()}
        victim = max(led, key=led.get)
        steppers = [n._stepper for n in c.nodes.values()]
        c.kill_node(victim)
        a0, t0 = audit.seconds, time.perf_counter()
        churn = 0
        while not (leaders() >= 1).all():
            tick_round()
            churn += 1
            if churn > 300:
                raise AssertionError(f"{int((leaders() == 0).sum())} "
                                     f"groups leaderless {churn} rounds "
                                     f"after the kill")
        churn_s = time.perf_counter() - t0 - (audit.seconds - a0)
        steppers.append(c.restart_node(victim)._stepper)
        drain = 0
        while True:
            tick_round()
            drain += 1
            hc = np.stack([n.h_commit for n in c.nodes.values()])
            if drain >= 10 and (hc == hc[0:1]).all() \
                    and (leaders() == 1).all():
                break
            if drain > 300:
                raise AssertionError(
                    f"not converged {drain} rounds after the restart: "
                    f"{int((hc != hc[0:1]).any(axis=0).sum())} groups with "
                    f"differing commits, {int((leaders() != 1).sum())} "
                    f"without exactly one leader")
        acked, everywhere = audit.check(sorted(c.nodes))
        launches = _launches("runtime")
        if launches != ticks or meas_launches != meas_ticks:
            raise AssertionError(f"quorum kernel launched {launches} times "
                                 f"in {ticks} node ticks (want one per "
                                 f"tick)")
        if acked == 0:
            raise AssertionError("no acknowledged submission in the sample")
        peak = torch.cuda.max_memory_allocated()
        kern = _kernel_entry("quorum_commit[runtime]", launches)
        native = bool(native_available() and node0._native_host)
        log(f"[runtime] {G} groups x 3 RaftNodes on the card, pipelined, "
            f"NullProvider: settle {settle} rounds ({settle_s:.1f}s incl. "
            f"boot); measured {RUNTIME_ROUNDS} rounds: "
            f"{commits / elapsed:.0f} durable commits/s, "
            f"{elapsed / RUNTIME_ROUNDS * 1e3:.1f} ms/round; slowest node "
            f"tick p50 <= {p50 * 1e3:.1f} ms, p99 <= {p99 * 1e3:.1f} ms "
            f"(2x histogram buckets), mean {mean * 1e3:.1f} ms, max "
            f"{top * 1e3:.1f} ms; stage "
            f"means (ms) " + ", ".join(
                f"{k} {v * 1e3:.2f}" for k, v in sorted(stages.items()))
            + f"; native WAL engine {native}")
        log(f"[runtime] churn: killed node {victim} (led {led[victim]} "
            f"groups); every group led again after {churn} rounds "
            f"({churn_s:.2f}s); restarted from its WAL, converged after "
            f"{drain} rounds; {acked} acknowledged submissions in "
            f"{RUNTIME_SAMPLE} sampled groups all read back ({everywhere} "
            f"on all 3 nodes; reading them took {audit.seconds:.1f}s, "
            f"outside the timings); quorum_commit {launches} launches in "
            f"{ticks} node ticks ({sum(st.replays for st in steppers)} of "
            f"them in replays of a captured node_step), "
            f"{_kernel_line(kern)}; peak memory "
            f"{peak / 2**30:.3f} GiB")
        return kern
    finally:
        c.close()
        shutil.rmtree(root, ignore_errors=True)


# [api-testnode]: BASELINE.json configs[0], the reference's TestNode1-3
# procedure (rafting_tpu_torch/tools/noderun.py): three node processes on
# the card, each loading through its own stub; the leader's process is
# killed and restarted from its data dir between two load windows.
TESTNODE_LOAD_S = 20.0
TESTNODE_XML = """<raft>
  <cluster>
    <local>{local}</local>
    <remote>{r0}</remote>
    <remote>{r1}</remote>
  </cluster>
  <storage dir="{dir}"/>
</raft>
"""


class _NodeProc:
    """One ``python -m rafting_tpu_torch.tools.noderun`` process (no
    ``--device``: it runs on the card); a thread collects its output."""

    def __init__(self, xml: str):
        import threading
        env = dict(os.environ)
        env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
        self.p = subprocess.Popen(
            [sys.executable, "-m", "rafting_tpu_torch.tools.noderun", xml],
            cwd=HERE, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        self.lines: list = []
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for ln in self.p.stdout:
            self.lines.append(ln.rstrip("\n"))

    def ready(self) -> bool:
        return any(ln.startswith("READY") for ln in self.lines)

    def tail(self) -> str:
        return "\n".join(self.lines[-25:])


def _smi_pids() -> set:
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return {int(x) for x in smi.stdout.split() if x.strip().isdigit()}


def _holds_card(pid: int) -> bool:
    """Whether process ``pid`` has the card's device node open."""
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return False
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia") and target[11:].isdigit():
            return True
    return False


def _until(pred, what: str, timeout: float, poll=None) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what} not reached in {timeout:.0f}s")
        if poll is not None:
            poll()
        time.sleep(0.05)


def phase_api_testnode() -> None:
    import tempfile
    from rafting_tpu_torch.testkit.harness import free_ports
    from rafting_tpu_torch.testkit.logcheck import check_logs

    root = tempfile.mkdtemp(prefix="testnode-")
    uris = [f"raft://127.0.0.1:{p}" for p in free_ports(3)]
    xmls, dirs = [], []
    for i in range(3):
        others = [u for j, u in enumerate(uris) if j != i]
        dirs.append(os.path.join(root, f"node{i}"))
        xmls.append(os.path.join(root, f"node{i}.xml"))
        with open(xmls[-1], "w") as f:
            f.write(TESTNODE_XML.format(local=uris[i], r0=others[0],
                                        r1=others[1], dir=dirs[-1]))
    seen, on_card, pids = set(), set(), []
    procs: list = []

    def acked(i: int) -> int:
        path = os.path.join(dirs[i], "acked.txt")
        if not os.path.exists(path):
            return 0
        with open(path) as f:
            return sum(1 for _ in f)

    def poll_smi():
        seen.update(_smi_pids())
        on_card.update(p.p.pid for p in procs
                       if p.p.poll() is None and _holds_card(p.p.pid))

    def load(seconds: float) -> None:
        end = time.monotonic() + seconds
        while time.monotonic() < end:
            poll_smi()
            time.sleep(1.0)

    try:
        t0 = time.perf_counter()
        procs = [_NodeProc(x) for x in xmls]
        pids += [p.p.pid for p in procs]
        _until(lambda: all(p.ready() for p in procs), "three nodes READY",
               300, poll_smi)
        ready_s = time.perf_counter() - t0
        a0 = [acked(i) for i in range(3)]
        load(TESTNODE_LOAD_S)
        a1 = [acked(i) for i in range(3)]

        def status(i: int) -> dict:
            try:
                with open(os.path.join(dirs[i], "status.json")) as f:
                    return json.load(f)
            except (OSError, ValueError):
                return {}

        def leader():
            for i in range(3):
                if status(i).get("leader") and procs[i].p.poll() is None:
                    return i
            return None
        _until(lambda: leader() is not None, "a node reporting leader", 60)
        victim = leader()
        procs[victim].p.kill()
        t_kill = time.perf_counter()
        procs[victim].p.wait(timeout=60)
        survivors = [i for i in range(3) if i != victim]
        base = sum(acked(i) for i in survivors)
        try:
            _until(lambda: sum(acked(i) for i in survivors) > base,
                   "an acknowledgement after the kill", 120)
        except AssertionError as e:
            raise AssertionError(f"{e} (killed node{victim}); each "
                                 f"survivor's status.json and output:\n"
                                 + "\n---\n".join(
                                     f"node{i} {status(i)}\n"
                                     f"{procs[i].tail()}"
                                     for i in survivors)) from None
        first_ack_s = time.perf_counter() - t_kill
        procs[victim] = _NodeProc(xmls[victim])
        pids.append(procs[victim].p.pid)
        _until(procs[victim].ready, "the restarted node READY", 300,
               poll_smi)
        a2 = [acked(i) for i in range(3)]
        load(TESTNODE_LOAD_S)
        a3 = [acked(i) for i in range(3)]
        for p in procs:
            p.p.send_signal(signal.SIGTERM)
        codes = [p.p.wait(timeout=120) for p in procs]
        if any(codes):
            raise AssertionError(
                f"noderun exit codes {codes}:\n" + "\n---\n".join(
                    p.tail() for p in procs))
        # nvidia-smi lists compute processes by the host's pids; inside a
        # PID namespace it lists none of ours, so the device node each
        # process holds open is the evidence there.
        missing = [pid for pid in pids if pid not in seen | on_card]
        if missing:
            raise AssertionError(
                f"node pids {missing} never seen on the card (nvidia-smi "
                f"listed {sorted(seen)}; /dev/nvidiaN held by "
                f"{sorted(on_card)})")
        # The reference's oracle (tests/test_system_tcp.py): byte-equal
        # files up to trailing election no-ops, which survivors append
        # when the processes stop one after another.
        files, noops = [], []
        for d in dirs:
            with open(os.path.join(d, "machines", "group_1.txt"), "rb") as f:
                lines = f.read().splitlines(keepends=True)
            n = len(lines)
            while lines and lines[-1].rstrip(b"\n").endswith(b":"):
                lines.pop()
            noops.append(n - len(lines))
            files.append(b"".join(lines))
        if not files[0] == files[1] == files[2]:
            tails = [f.splitlines()[-3:] for f in files]
            raise AssertionError(f"the three machine files differ: "
                                 f"lengths {[len(f) for f in files]}, "
                                 f"tails {tails}")
        body: dict = {}
        for ln in files[0].decode().splitlines():
            payload = ln.split(":", 1)[1]
            body[payload] = body.get(payload, 0) + 1
        n_acked = 0
        for d in dirs:
            with open(os.path.join(d, "acked.txt")) as f:
                for payload in f.read().split():
                    if body.get(payload) != 1:
                        raise AssertionError(
                            f"acknowledged {payload} is in the machine file "
                            f"{body.get(payload, 0)} times")
                    n_acked += 1
        divs = check_logs([os.path.join(d, "wal") for d in dirs])
        if divs:
            raise AssertionError(f"log divergence: {divs[:5]}")
        rates = [((a1[i] - a0[i]) / TESTNODE_LOAD_S,
                  (a3[i] - a2[i]) / TESTNODE_LOAD_S) for i in range(3)]
        log(f"[api-testnode] BASELINE configs[0]: 3 noderun processes on the "
            f"card (pids {pids}; nvidia-smi listed "
            f"{sorted(set(pids) & seen)}, /dev/nvidiaN open in "
            f"{sorted(set(pids) & on_card)}), READY after "
            f"{ready_s:.1f}s; acked commands/s per node before / after the "
            f"kill: " + ", ".join(f"node{i} {a:.2f} / {b:.2f}"
                                  for i, (a, b) in enumerate(rates))
            + f"; killed the leader node{victim}, first acknowledgement "
            f"{first_ack_s:.2f}s after the kill; {n_acked} acknowledged "
            f"payloads each in the machine file once, "
            f"{len(files[0].splitlines())} lines byte-equal on 3 nodes "
            f"(trailing no-ops {noops}), check_logs clean")
    finally:
        for p in procs:
            if p.p.poll() is None:
                p.p.kill()
                p.p.wait()
        shutil.rmtree(root, ignore_errors=True)


# [api-1k]: BASELINE.json configs[1] (Multi-Raft 1k groups, 3 peers,
# AppendEntries only: PreVote off, no snapshot in the window) through
# three RaftContainers on the card over localhost TCP.  Two fields move off
# the defaults (PERF.md §4): tick_ms is 250, not 20, since the three nodes
# share one process, where a tick takes longer than 3 x 20 ms, and a loop
# slower than 3 x tick_ms vetoes every read (runtime/node.py:1668-1676);
# election_mul is 10, not 3, since at 3 it took 175 s on the H100 until
# every group had a ready leader (split votes with PreVote off).  Waves
# are cut from 2 + 10 to 1 + 5: one H100 machine took 341 s for 1 + 7
# (waves of 17-73 s), which brought the whole script to 1,167 s.
# Every wave is issued in full and waited for.  A group is served in a wave
# when a set and a get of it were acknowledged; it is forwarded when its
# stub's container did not lead it as the wave began.  Admission control
# and the client's circuit breakers shed part of each burst by design (a
# wave with open breakers served 6.5% of its forwarded groups on the
# H100), so the floors are these (PERF.md §4): every measured wave serves
# at least API_WAVE_FLOOR of the groups and at least one forwarded group,
# and over the measured waves at least API_FLOOR of the groups were
# served, and of the groups ever forwarded, at least API_FLOOR were
# served while forwarded.
API_LANES, API_GROUPS = 1024, 1000
API_TICK_MS = 250
API_ELECTION_MUL = 10.0
API_WARMUP, API_WAVES = 1, 5
API_OP_S = 60.0              # the client's budget for one operation
# A wave can leave RPC timeouts behind it, and a leader reports not-ready
# for recovery_cool_down_ticks (10) after its peer's last one: on the
# H100 one wave issued at once after the warm-up found 3% of the groups
# ready and served 3.0% (PERF.md §7).  So a wave is issued once every
# group has a ready leader again, the phase's start condition.  That
# wait lies inside the measured window, and the phase fails when it
# outlasts API_READY_TICKS ticks of the slowest node, twice the
# cool-down, so that a recovery stall fails the phase.
API_READY_TICKS = 20
API_WAVE_FLOOR, API_FLOOR = 0.2, 0.9
API_SAMPLE = 64
API_VALUE = 64
API_MEM_S = 5.0
# A forward holds no thread while it waits (api/stub.py ForwardPool, at
# most 32 workers a container; transport/forward_io.py, one reactor a
# transport): a wave once started ~3,900 (PERF.md §7).
API_MAX_THREADS = 1500


def _quantile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _record_ticks(node, out: list) -> None:
    """Append ``(end, seconds)`` of each of ``node``'s ticks to ``out``
    (for the printed tick times only; the tick is unchanged)."""
    real = node.tick

    def tick():
        t0 = time.perf_counter()
        try:
            return real()
        finally:
            t1 = time.perf_counter()
            out.append((t1, t1 - t0))
    node.tick = tick


def _tick_times(tick_log: dict, lo: float, hi: float) -> str:
    """Each node's ticks that ended in [lo, hi]: count, p50 and max."""
    parts = []
    for nid, rec in sorted(tick_log.items()):
        d = [dt for t, dt in list(rec) if lo <= t <= hi]
        parts.append(f"node{nid} {len(d)} ticks, p50 "
                     f"{_quantile(d, 0.5) * 1e3:.0f} ms, max "
                     f"{max(d) * 1e3:.0f} ms" if d else f"node{nid} 0 ticks")
    return "; ".join(parts)


def _api_health(nodes, idx: np.ndarray, now0: dict) -> list:
    """One line per node on its leaders' peer health, read from the
    step's lanes: the groups it leads, of them not ready, and for each
    peer the led groups that peer is unhealthy in for a timeout within
    recovery_ticks, for a fail streak past avail_crit or for no reply yet,
    the led (group, peer) pairs that timed out since the node's tick
    ``now0[node]``, and the largest fail streak.  Last, the groups that
    are not ready by the node that leads them."""
    from rafting_tpu_torch import LEADER, NIL
    lines = []
    lead_of = np.full(idx.size, -1)
    best = np.full(idx.size, -1)
    not_ready = np.ones(idx.size, bool)
    for n in nodes:
        s = n.state
        now = int(s.now)
        fenced = (s.xfer_to[idx] != NIL).cpu().numpy()
        snap = s.need_snap[idx].cpu().numpy()
        fa = s.fail_at[idx].cpu().numpy()
        fs = s.fail_streak[idx].cpu().numpy()
        ok = s.ok_at[idx].cpu().numpy()
        role, ready, term = n.h_role[idx], n.h_ready[idx], n.h_term[idx]
        led = role == LEADER
        nr = led & ~ready
        mine = led & (term > best)
        lead_of[mine], best[mine] = n.node_id, term[mine]
        not_ready[led & ready] = False
        cfg = n.cfg
        peers = []
        for p in range(cfg.n_peers):
            if p == n.node_id:
                continue
            recent = (fa[:, p] > 0) & (now - fa[:, p] < cfg.recovery_ticks)
            streak = fs[:, p] > cfg.avail_crit
            silent = ok[:, p] == 0
            since = fa[:, p] >= now0.get(n.node_id, now)
            peers.append(
                f"peer{p}: recent timeout {int((led & recent).sum())} "
                f"({int((nr & recent).sum())} not ready), streak "
                f"{int((led & streak).sum())} ({int((nr & streak).sum())}), "
                f"no reply {int((led & silent).sum())} "
                f"({int((nr & silent).sum())}), timed out since "
                f"{int((led & since).sum())}, fail_streak max "
                f"{int(fs[led, p].max(initial=0))}")
        h = n.health
        lines.append(
            f"node{n.node_id} (tick {now}) leads {int(led.sum())}, "
            f"{int(nr.sum())} not ready ({int((nr & fenced).sum())} in a "
            f"leadership transfer, {int((nr & snap.any(axis=1)).sum())} "
            f"with a peer needing a snapshot); evacuations "
            f"{int(n.metrics['leader_evacuations'])}, self score "
            f"{h._decayed(h.self_score) if h else 0.0:.2f}; "
            + "; ".join(peers))
    lines.append("not ready by leader: " + ", ".join(
        f"node{k} {int((not_ready & (lead_of == k)).sum())}"
        for k in sorted({n.node_id for n in nodes})) +
        f", no leader {int((lead_of < 0).sum())}")
    return lines


def _qc_device_us(trace: str) -> tuple:
    """Mean device time of the quorum kernel's launches, their count, and
    the kernels' share of the window, from a chrome trace."""
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    qc = [e["dur"] for e in kern if "qc_kernel" in e.get("name", "")]
    if not qc:
        raise AssertionError("the profiled tick shows no qc_kernel")
    span = [e for e in events if e.get("ph") == "X" and "dur" in e]
    lo = min(e["ts"] for e in span)
    hi = max(e["ts"] + e["dur"] for e in span)
    return (sum(qc) / len(qc), len(qc),
            sum(e["dur"] for e in kern) / max(hi - lo, 1e-9))


def phase_api_1k() -> dict:
    import collections
    import re
    import tempfile
    import threading
    from rafting_tpu_torch import LEADER, RaftConfig, RaftContainer, \
        RaftFactory
    from rafting_tpu_torch.machine import KVMachineProvider
    from rafting_tpu_torch.ops import quorum
    from rafting_tpu_torch.testkit import linz
    from rafting_tpu_torch.testkit.harness import free_ports
    from rafting_tpu_torch.testkit.history import History, StubRecorder

    class KVFactory(RaftFactory):
        def machine_provider(self, config, node_id):
            return KVMachineProvider(os.path.join(config.data_dir, "kv"))

    root = tempfile.mkdtemp(prefix="api1k-")
    uris = [f"raft://127.0.0.1:{p}" for p in free_ports(3)]
    cfgs = [RaftConfig(local=uris[i],
                       peers=tuple(u for j, u in enumerate(uris) if j != i),
                       n_groups=API_LANES, pre_vote=False, tick_ms=API_TICK_MS,
                       election_mul=API_ELECTION_MUL, seed=0,
                       data_dir=os.path.join(root, f"node{i}"))
            for i in range(3)]
    names = [f"g{g:04d}" for g in range(API_GROUPS)]
    sample = set(np.random.default_rng(0).choice(
        API_GROUPS, API_SAMPLE, replace=False).tolist())
    histories = {g: History() for g in sample}
    gs = np.arange(API_GROUPS)
    lock = threading.Lock()
    lat: list = []               # latency of each acknowledged operation
    acked_sets: list = []        # (lane, key, value)
    counts = {"ok": 0, "failed": 0, "pending": 0}
    fails: dict = {}             # failed ops by kind and exception type
    why: dict = {}               # the first message of each
    cs: list = []
    stack0 = None
    stop_mem = threading.Event()
    torch.cuda.reset_peak_memory_stats()
    quorum.reset_launch_counts()
    t_boot = time.perf_counter()
    try:
        cs = [RaftContainer(cfg, KVFactory(), admin=False).create()
              for cfg in cfgs]
        lanes = [[c.open_context(n) for n in names] for c in cs]
        if not lanes[0] == lanes[1] == lanes[2] == \
                list(range(1, API_GROUPS + 1)):
            raise AssertionError("the containers gave the names different "
                                 "lanes")
        lane_of = lanes[0]
        idx = np.array(lane_of)
        tick_log = {c.node.node_id: [] for c in cs}
        for c in cs:
            _record_ticks(c.node, tick_log[c.node.node_id])
        # The last wave's start: its wall time and each node's tick clock.
        last_wave = {"t": time.perf_counter(), "now": {}}

        def led_ready() -> float:
            """The share of the groups with a ready leader."""
            led = np.zeros(API_GROUPS, bool)
            for c in cs:
                n = c.node
                led |= (n.h_role[idx] == LEADER) & n.h_ready[idx]
            return float(led.mean())
        _until(lambda: led_ready() == 1.0, "a ready leader in every group",
               240)
        settle_s = time.perf_counter() - t_boot
        log(f"[api-1k] every group led and ready after {settle_s:.1f}s; "
            f"{_mem()}")
        stubs = [cs[g % 3].get_stub(names[g]) for g in range(API_GROUPS)]
        # A wave once ran each forwarded operation on a client thread and
        # a serving thread of its own, ~4,000 in all; at the default 8 MiB
        # stack that mapped 32 GiB.  2 MiB each is ample for any thread.
        stack0 = threading.stack_size(2 << 20)

        def wave(w: int) -> dict:
            """Issue the whole wave, wait for it, and return which groups
            had a set and a get acknowledged, and which were forwarded."""
            roles = np.stack([c.node.h_role[idx] for c in cs])
            st = {"set": np.zeros(API_GROUPS, int),
                  "get": np.zeros(API_GROUPS, bool),
                  "fwd": roles[gs % 3, gs] != LEADER}
            futs = []

            def issue(call, payload, g, rec, kind, key, val=None):
                op = rec.history.invoke(rec.proc, kind, key, val) \
                    if rec else None
                t0 = time.perf_counter()

                def done(f):
                    exc = f.exception()
                    with lock:
                        counts["failed" if exc else "ok"] += 1
                        if exc is not None:
                            k = f"{'set' if kind == 'w' else 'get'} " \
                                f"{type(exc).__name__}"
                            fails[k] = fails.get(k, 0) + 1
                            why.setdefault(k, str(exc)[:100])
                        else:
                            lat.append(time.perf_counter() - t0)
                            if kind == "w":
                                st["set"][g] += 1
                                acked_sets.append((lane_of[g], key, val))
                            else:
                                st["get"][g] = True
                    if rec is not None:
                        if exc is None:
                            rec.history.ok(op, f.result())
                        else:
                            rec._classify(op, exc)
                fut = call(payload, timeout=API_OP_S)
                fut.add_done_callback(done)
                futs.append(fut)

            for g in range(API_GROUPS):
                stub = stubs[g]
                rec = StubRecorder(histories[g], f"c{g % 3}") \
                    if g in sample else None
                for tag in ("a", "b"):
                    key = f"{tag}{w}"
                    val = f"g{g}-w{w}-{tag}".ljust(API_VALUE, "v")
                    issue(stub.submit, json.dumps(
                        {"op": "set", "k": key, "v": val}), g, rec, "w",
                        key, val)
                key = f"a{w - 1}"
                issue(stub.read, json.dumps({"op": "get", "k": key}), g,
                      rec, "r", key)
            # A local future may pend past the client's budget (stub.submit
            # bounds only the forward chase): what is not done by then
            # counts as not acknowledged.
            deadline = time.monotonic() + API_OP_S + 10.0
            for f in futs:
                try:
                    f.result(timeout=max(0.0, deadline - time.monotonic()))
                except Exception:
                    pass
            with lock:
                counts["pending"] += sum(1 for f in futs if not f.done())
            return st

        def logged_wave(w: int, label: str) -> tuple:
            # Issued once every group has a ready leader again; past
            # API_READY_TICKS ticks of the slowest node the phase fails.
            tr = time.perf_counter()
            ready = led_ready()
            ticks0 = [c.node.ticks for c in cs]
            waited_ticks = 0
            nodes = [c.node for c in cs]
            if ready < 1.0:
                for line in _api_health(nodes, idx, last_wave["now"]):
                    log(f"[api-1k]   {label} wave {w} wait begins: {line}")

            def wait_lines(what: str) -> None:
                now = time.perf_counter()
                log(f"[api-1k]   {label} wave {w} {what}: ticks advanced "
                    f"{[c.node.ticks - t for c, t in zip(cs, ticks0)]}; "
                    f"ticks over the wait: {_tick_times(tick_log, tr, now)}"
                    f"; over the last wave: "
                    f"{_tick_times(tick_log, last_wave['t'], tr)} "
                    f"({_CARD[0]})")
            while led_ready() < 1.0:
                waited_ticks = min(c.node.ticks - t for c, t in
                                   zip(cs, ticks0))
                if waited_ticks > API_READY_TICKS:
                    share = led_ready()
                    wait_lines("wait failed")
                    for line in _api_health(nodes, idx, last_wave["now"]):
                        log(f"[api-1k]   {label} wave {w} wait failed: "
                            f"{line}")
                    raise AssertionError(
                        f"{label} wave {w}: {share:.1%} of the groups "
                        f"had a ready leader {waited_ticks} ticks after the "
                        f"last wave (limit {API_READY_TICKS})")
                time.sleep(0.05)
            waited = time.perf_counter() - tr
            wait_lines("wait ended")
            tw = time.perf_counter()
            last_wave.update(t=tw, now={n.node_id: int(n.state.now)
                                        for n in nodes})
            st = wave(w)
            served = (st["set"] > 0) & st["get"]
            share = (float(served.mean()), float(served[st["fwd"]].mean()))
            with lock:
                log(f"[api-1k] {label} wave {w}: {ready:.1%} of the groups "
                    f"led and ready as the last wave ended, all after "
                    f"{waited:.2f}s ({waited_ticks} ticks); "
                    f"{time.perf_counter() - tw:.2f}s, served "
                    f"{share[0]:.1%} of the groups, {share[1]:.1%} of the "
                    f"{int(st['fwd'].sum())} forwarded ones; ops so far "
                    f"{counts}, failed by type {fails}, e.g. {why}; "
                    f"{_mem()}")
            return share, served, st["fwd"]

        def sample_mem():
            # The process has been killed inside a wave (PERF.md §7):
            # its memory and threads every API_MEM_S, until the end, and
            # the OS thread count's peak, read every 0.25 s.
            k = 0
            while not stop_mem.wait(0.25):
                n = _os_threads()
                if n > peak_threads[0]:
                    peak_threads[:] = [n, collections.Counter(
                        re.sub(r"[-\d>]+$", "",
                               t.name.split("(")[-1].rstrip(")"))
                        for t in threading.enumerate()).most_common(5)]
                k += 1
                if k % int(API_MEM_S / 0.25) == 0:
                    log(f"[api-1k]   [mem] {_mem()}")
        peak_threads = [_os_threads(), []]   # and the Python threads then
        threading.Thread(target=sample_mem, daemon=True).start()
        for w in range(API_WARMUP):
            logged_wave(w, "warm-up")
        for c in cs:
            c.node.metrics.histogram("tick_latency_s").reset()
            for stage in c.node.metrics.breakdown():
                c.node.metrics.histogram(f"tick_stage_{stage}").reset()
        with lock:
            lat.clear()
            counts.update({"ok": 0, "failed": 0, "pending": 0})
            n_sets0 = len(acked_sets)
        t0 = time.perf_counter()
        shares = []
        served = np.zeros(API_GROUPS, bool)
        fwd_served = np.zeros(API_GROUPS, bool)
        fwd_ever = np.zeros(API_GROUPS, bool)
        for w in range(API_WAVES):
            share, srv, fwd = logged_wave(API_WARMUP + w, "measured")
            shares.append(share)
            served |= srv
            fwd_served |= srv & fwd
            fwd_ever |= fwd
            log(f"[api-1k]   served so far {served.mean():.1%} of the groups, "
                f"{fwd_served.sum() / max(fwd_ever.sum(), 1):.1%} of the "
                f"ones forwarded while forwarded")
            if share[0] < API_WAVE_FLOOR or not (srv & fwd).any():
                raise AssertionError(
                    f"measured wave {w} served {share[0]:.1%} of the groups "
                    f"(floor {API_WAVE_FLOOR:.0%}) and "
                    f"{int((srv & fwd).sum())} forwarded ones (floor 1)")
        secs = time.perf_counter() - t0
        cover = (float(served.mean()),
                 float(fwd_served.sum() / max(fwd_ever.sum(), 1)))
        if min(cover) < API_FLOOR:
            raise AssertionError(
                f"the measured waves served {cover[0]:.1%} of the groups, "
                f"and {cover[1]:.1%} of the groups ever forwarded while "
                f"forwarded, under the {API_FLOOR:.0%} floor")
        with lock:
            meas_lat, ok, failed = list(lat), counts["ok"], counts["failed"]
            pending = counts["pending"]
            meas_sets = len(acked_sets) - n_sets0
        ticks = {}
        for c in cs:
            h = c.node.metrics.histogram("tick_latency_s")
            ticks[c.node.node_id] = (
                h.total / max(h.n, 1), h.quantile(0.99),
                {k: v["mean"] for k, v in c.node.metrics.breakdown().items()})
        log(f"[api-1k] node ticks over the measured waves: "
            f"{_tick_times(tick_log, t0, t0 + secs)} ({_CARD[0]})")

        # A window holding one whole node tick of container 0 (the two
        # other nodes tick in it too) under torch.profiler.
        from torch.profiler import ProfilerActivity, profile
        trace = os.path.join(root, "tick_trace.json")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            n0 = cs[0].node.ticks
            _until(lambda: cs[0].node.ticks >= n0 + 2,
                   "two ticks of container 0", 120)
        prof.export_chrome_trace(trace)
        qc_us, qc_n, busy = _qc_device_us(trace)

        # Drain: every node applied every lane to the same commit index.
        # Every set acknowledged before the drain is then on every node.
        with lock:
            acked = list(acked_sets)

        def drained() -> bool:
            hc = np.stack([c.node.h_commit[idx] for c in cs])
            ap = np.stack([[c.node.dispatcher.applied(int(l))
                            for l in lane_of] for c in cs])
            return bool((hc == hc[0:1]).all() and (ap == hc).all())
        _until(drained, "every replica applied every commit", 120)
        lost = [(lane, k) for c in cs for lane, k, v in acked
                if c.node.dispatcher.machine(lane).data.get(k) != v]
        if lost:
            raise AssertionError(f"{len(lost)} acknowledged sets do not read "
                                 f"back, first {lost[:3]}")
        bad = [g for g, h in sorted(histories.items())
               if not linz.check(h).ok]
        if bad:
            raise AssertionError(f"linz.check failed in groups {bad[:4]}: "
                                 f"{linz.check(histories[bad[0]]).render()}")
        snaps = [c.node.metrics["snapshots_taken"] for c in cs]
        if any(snaps):
            raise AssertionError(f"snapshots taken in the window: {snaps}")
        node0 = cs[0].node
        peak = torch.cuda.max_memory_allocated()
        replayed = sum(c.node._stepper.replays for c in cs)
        for c in cs:
            c.destroy()
        # The three loops have stopped: every node tick launched the
        # kernel once.
        launches = _launches("api-1k")
        all_ticks = sum(c.node.ticks for c in cs)
        if launches != all_ticks:
            raise AssertionError(
                f"quorum kernel: {launches} launches in {all_ticks} node "
                f"ticks of the three containers (want one per tick)")
        import resource
        rss_peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        log(f"[api-1k] peak over the phase: {peak_threads[0]} OS threads "
            f"(limit {API_MAX_THREADS}; the most common Python threads "
            f"then {peak_threads[1]}), rss {rss_peak:.2f} GiB (the "
            f"process's peak so far)")
        if peak_threads[0] > API_MAX_THREADS:
            raise AssertionError(f"{peak_threads[0]} OS threads at the peak "
                                 f"(limit {API_MAX_THREADS})")
        kern = _kernel_entry("quorum_commit[api-1k]", launches)
        log(f"[api-1k] BASELINE configs[1]: {API_GROUPS} groups (n_groups "
            f"{API_LANES}) x 3 RaftContainers on the card over TCP, KV machine, "
            f"PreVote off; every group led and ready "
            f"{settle_s:.1f}s after boot; {API_WAVES} measured waves after "
            f"{API_WARMUP} (tick_ms {API_TICK_MS}, election "
            f"x{API_ELECTION_MUL:g}), {secs / API_WAVES:.2f}s/wave: "
            f"{ok / secs:.0f} acked ops/s, {meas_sets / secs:.0f} sets/s, "
            f"{ok} acknowledged, {failed} failed and {pending} pending of "
            f"{3 * API_GROUPS * API_WAVES}; each measured wave served "
            f"{min(s[0] for s in shares):.1%}-{max(s[0] for s in shares):.1%}"
            f" of the groups (floor {API_WAVE_FLOOR:.0%}) and "
            f"{min(s[1] for s in shares):.1%}-{max(s[1] for s in shares):.1%}"
            f" of the forwarded ones (floor one group); the waves served {cover[0]:.1%} of the "
            f"groups and {cover[1]:.1%} of the forwarded ones while "
            f"forwarded (floor {API_FLOOR:.0%}); acknowledged "
            f"latency p50 {_quantile(meas_lat, 0.5) * 1e3:.1f} ms, p99 "
            f"{_quantile(meas_lat, 0.99) * 1e3:.1f} ms")
        for nid, (mean, p99, stages) in sorted(ticks.items()):
            log(f"[api-1k]   node{nid}: tick mean {mean * 1e3:.1f} ms, p99 <= "
                f"{p99 * 1e3:.1f} ms; stage means (ms) " + ", ".join(
                    f"{k} {v * 1e3:.2f}" for k, v in sorted(stages.items())))
        log(f"[api-1k] {len(acked)} acknowledged sets read back on 3 "
            f"nodes; linz.check ok on {len(histories)} sampled groups "
            f"({sum(len(h.ops()) for h in histories.values())} ops); "
            f"snapshots_taken 0; {launches} quorum_commit launches in "
            f"{all_ticks} node ticks of the three containers ({replayed} "
            f"of them in replays of a captured node_step); profiled "
            f"window (one whole tick of container 0): qc_kernel "
            f"{qc_us:.2f} us device time per launch over {qc_n} launches, "
            f"kernels busy {busy:.1%} of the window; {_kernel_line(kern)}; "
            f"peak memory {peak / 2**30:.3f} GiB")
        return kern
    finally:
        stop_mem.set()
        if stack0 is not None:
            threading.stack_size(stack0)
        for c in cs:
            c.destroy()
        shutil.rmtree(root, ignore_errors=True)


# [oracle]: the port's node_step on the card against the scalar oracle on
# the host, every lane of every tick (rafting_tpu_torch/testkit/parity.py,
# the loop of tests/test_oracle_parity.py): seeded drops, partitions,
# crash-restarts and clock stalls, membership and transfer offers through
# the host inbox.  (a) BASELINE.json configs[1]'s width, PreVote and the
# lease on; (b) the nemesis shape (configs[3]'s flags) at 256 groups x 5.
# Each node steps on its own, so every node_step call launches the kernel
# once.
ORACLE_CHAOS = dict(drop_p=0.15, part_p=0.1, crash_p=0.04, stall_p=0.06,
                    conf_p=0.02, xfer_p=0.02)
ORACLE_SHAPE = dict(log_slots=64, batch=8, max_submit=8, election_ticks=10,
                    heartbeat_ticks=3, rpc_timeout_ticks=8, pre_vote=True)
ORACLE_RUNS = (
    ("a", dict(n_groups=1024, n_peers=3, **ORACLE_SHAPE), 1, 60),
    ("b", dict(n_groups=256, n_peers=5, trace_depth=16, heat=True,
               check_quorum=True, debug_checks=True, **ORACLE_SHAPE), 2, 50),
)


def phase_oracle() -> dict:
    from rafting_tpu_torch import EngineConfig
    from rafting_tpu_torch.ops import quorum
    from rafting_tpu_torch.testkit.parity import run_parity

    launches = steps = 0
    t_phase = time.perf_counter()
    for name, kw, seed, ticks in ORACLE_RUNS:
        cfg = EngineConfig(**kw)
        quorum.reset_launch_counts()
        t0 = time.perf_counter()
        states, st = run_parity(seed, ticks, cfg, "cuda", **ORACLE_CHAOS)
        secs = time.perf_counter() - t0
        n = _launches("oracle")
        if n != st["steps"]:
            raise AssertionError(f"[oracle] ({name}): {n} kernel launches "
                                 f"in {st['steps']} node_step calls")
        for what in ("elections", "commits", "crashes", "partitions"):
            if not st[what]:
                raise AssertionError(f"[oracle] ({name}) vacuous: no "
                                     f"{what} in the run")
        extra = ""
        if cfg.trace_depth:
            ev = sum(int(s.trace.n.sum()) for s in states)
            rpcs = sum(int(s.heat.sent.sum()) for s in states)
            if not (ev and rpcs):
                raise AssertionError(f"[oracle] ({name}) vacuous: recorder "
                                     f"{ev} events, heat {rpcs} rpcs")
            extra = f", {ev} recorder events, {rpcs} heat rpcs"
        launches += n
        steps += st["steps"]
        log(f"[oracle] ({name}) {cfg.n_groups} groups x {cfg.n_peers} "
            f"nodes, {ticks} ticks, seed {seed}: node_step on CUDA == "
            f"oracle on the host, every state lane, outbound message and "
            f"step info field at each of {st['steps']} steps; "
            f"{st['elections']} elections, {st['commits']} commit advances, "
            f"{st['crashes']} crash-restarts, {st['stalls']} stalls, "
            f"{st['partitions']} partitions{extra}; {secs:.1f}s "
            f"(oracle {st['oracle_s']:.1f}s, step "
            f"{st['step_s'] / st['steps'] * 1e3:.2f} ms/call); "
            f"{n} quorum_commit launches")
    kern = _kernel_entry("quorum_commit[oracle]", launches)
    log(f"[oracle] {steps} node_step calls lane-exact in "
        f"{time.perf_counter() - t_phase:.1f}s; quorum_commit {launches} "
        f"launches, {_kernel_line(kern)}")
    return kern


# [snapshot]: BASELINE.json configs[4] (100k groups with InstallSnapshot
# lagging-follower catch-up), driven as tools/validate_config5.py drives
# it: elect under load, isolate node 2 while the majority commits and
# compacts (every 16 ticks) past its frozen tail in every group, heal,
# and every group must catch the victim up by a floor jump (the snapshot
# plane, step phases 5 and 9), with the in-step debug checks on.
SNAP_ROUND = 30


def phase_snapshot() -> dict:
    from rafting_tpu_torch import LEADER, DeviceCluster, EngineConfig
    from rafting_tpu_torch.ops import quorum

    cfg = EngineConfig(n_groups=100_000, n_peers=3, log_slots=64, batch=8,
                       max_submit=8, election_ticks=10, heartbeat_ticks=3,
                       rpc_timeout_ticks=8, debug_checks=True)
    G, victim = cfg.n_groups, 2
    torch.cuda.reset_peak_memory_stats()
    c = DeviceCluster(cfg, seed=5, device="cuda")
    c.compact = 16
    host = lambda t: t.cpu().numpy()
    ticks, tick_s = 0, 0.0
    installs = torch.zeros((), dtype=torch.int64, device="cuda")

    def run(k, submit_n=None):
        nonlocal ticks, tick_s, installs
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            info = c.tick(submit_n=submit_n)
            installs += info.snap_req[victim].sum()
        torch.cuda.synchronize()
        tick_s += time.perf_counter() - t0
        ticks += k

    quorum.reset_launch_counts()
    t_phase = time.perf_counter()
    run(60, 4)
    n_lead = (host(c.states.role) == LEADER).sum(axis=0)
    if not (n_lead == 1).all():
        raise AssertionError(f"{int((n_lead != 1).sum())} groups without "
                             f"exactly one leader after 60 ticks")
    victim_tail = host(c.states.log.last)[victim].copy()
    c.isolate(victim)
    iso = 0
    for iso in range(1, 13):
        run(SNAP_ROUND, 4)
        past = host(c.states.log.base)[:2].min(axis=0) > victim_tail
        if past.all():
            break
    if not past.all():
        raise AssertionError(f"compaction passed the victim's tail in only "
                             f"{int(past.sum())} of {G} groups")
    c.heal()
    majority = host(c.states.commit)[:2].max(axis=0)
    installs.zero_()
    heal = 0
    for heal in range(1, 11):
        run(SNAP_ROUND, 4)
        caught = host(c.states.commit)[victim] >= majority
        if caught.all():
            break
    if not caught.all():
        raise AssertionError(f"victim stuck on {int((~caught).sum())} "
                             f"groups after {heal} rounds")
    run(40)
    launches = _launches("snapshot")
    v_base = host(c.states.log.base)[victim]
    if not (v_base > victim_tail).all():
        raise AssertionError(f"{int((v_base <= victim_tail).sum())} groups "
                             f"caught up without a floor jump")
    lead = host(c.states.role) == LEADER
    if (host(c.states.need_snap) & lead[:, :, None]).any():
        raise AssertionError("pending installations remain on live leaders")
    if launches != ticks:
        raise AssertionError(f"quorum kernel launched {launches} times in "
                             f"{ticks} ticks (want one per tick)")
    peak = torch.cuda.max_memory_allocated()
    kern = _kernel_entry("quorum_commit[snapshot]", launches)
    log(f"[snapshot] BASELINE configs[4]: {G} groups x 3 nodes, debug "
        f"checks on, seed 5, compaction every 16 ticks: one leader per "
        f"group after 60 ticks; node {victim} isolated, every floor past "
        f"its tail after {iso} rounds of {SNAP_ROUND} ticks; healed, "
        f"caught up in every group after {heal} rounds "
        f"({int(installs)} group-ticks of snapshot requests by the "
        f"victim), 40-tick drain; every group by floor jump (victim floor "
        f"past its old tail by {int((v_base - victim_tail).min())} entries "
        f"at least), no need_snap on a live leader, no debug "
        f"violation; {ticks} ticks, {tick_s / ticks * 1e3:.3f} ms/tick, "
        f"{time.perf_counter() - t_phase:.1f}s; peak memory "
        f"{peak / 2**30:.3f} GiB; quorum_commit {launches} launches, "
        f"{_kernel_line(kern)}")
    return kern


# [chaos]: the chaos_run twin (rafting_tpu_torch/tools/chaos_run.py) on
# the card, at the settings of the JAX package's committed CPU artifacts
# (their argv): (a) the mixed-nemesis KV soak, (b) the stale-read
# self-test, (c) the leader-isolate gray failure with CheckQuorum,
# (d) one seeded round of the bank transfer soak.
#
# chaos_run runs the serial node runtime, as those artifacts did, and
# takes its admission target from a conductor step it measures on a
# throwaway cluster (tools/chaos_run.py); the phase passes it arguments
# only.
# The isolate soak's clients recover on the wall clock while its budget
# counts ticks, so (c) is paced (--tick-wall) to the committed artifact's
# wall time per tick: 64.13 s over 222 ticks.
CHAOS_ISOLATE_TICK_S = 64.13 / 222
# Cuts for a phase within its 120 s target (on an H100 the phase took
# 159.8 s with the artifacts' 240 and 400 ticks, and 149.8 s with the
# transfer round at 200): the isolate soak places its one cut at tick
# ~50 instead of ~100 (period 50, horizon 130 ticks instead of 240; a
# paced tick costs 0.29 s), and the transfer round runs 100 ticks
# instead of 400.
CHAOS_ISOLATE_ARGS = ("--ticks", "130", "--isolate-period", "50",
                      "--tick-wall", f"{CHAOS_ISOLATE_TICK_S:.4f}")
CHAOS_TRANSFER_TICKS = 100


def _acked_per_client(history: list) -> dict:
    """proc -> [acknowledged writes, acknowledged reads] from a chaos
    artifact's raw event list."""
    kinds, out = {}, {}
    for ev in history:
        if ev["e"] == "invoke":
            kinds[ev["id"]] = (ev["proc"], ev["kind"])
        elif ev["e"] == "ok":
            proc, kind = kinds[ev["id"]]
            out.setdefault(proc, [0, 0])[kind == "r"] += 1
    return out


def phase_chaos() -> dict:
    import gzip
    import tempfile
    from rafting_tpu_torch.ops import quorum
    from rafting_tpu_torch.runtime.node import RaftNode
    from rafting_tpu_torch.tools import _artifact, chaos_run

    with open(os.path.join(HERE, "artifacts", "chaos_soak_cpu_000.json")) \
            as f:
        committed = json.load(f)["config"]["timeline_canonical"]
    root = tempfile.mkdtemp(prefix="chaos-")
    node_ticks = [0]
    orig_tick = RaftNode.tick

    def counted_tick(self):
        node_ticks[0] += 1
        return orig_tick(self)

    def soak(tag, *argv):
        args = chaos_run.parse_args(
            ["--device", "cuda", "--root", os.path.join(root, tag), *argv])
        node_ticks[0] = 0
        quorum.reset_launch_counts()
        t0 = time.perf_counter()
        ok, doc, path = chaos_run.soak(args)
        secs = time.perf_counter() - t0
        with gzip.open(path, "rt") as f:
            doc["phases"] = {p["phase"]: p for p in json.load(f)["phases"]}
        log(f"[chaos] ({tag}) {secs:.1f}s: " + ", ".join(
            f"{k} at {v['t_s']}s" for k, v in doc["phases"].items()))
        n = _launches("chaos")
        if not ok:
            raise AssertionError(f"[chaos] ({tag}): the verdict did not "
                                 f"match the expectation: {doc['verdict']}")
        if n != node_ticks[0]:
            raise AssertionError(f"[chaos] ({tag}): {n} kernel launches in "
                                 f"{node_ticks[0]} node ticks")
        return doc, secs, n

    def kv_counts(tag, doc):
        per = _acked_per_client(doc["history"])
        if len(per) < 3 or not all(w >= 1 and r >= 1
                                   for w, r in per.values()):
            raise AssertionError(f"[chaos] ({tag}) vacuous: acknowledged "
                                 f"(writes, reads) per client {per}")
        return ", ".join(f"{p} {w}w/{r}r" for p, (w, r) in sorted(per.items()))

    art0 = _artifact.ARTIFACT_DIR
    _artifact.ARTIFACT_DIR = os.path.join(root, "art")
    launches = 0
    t_phase = time.perf_counter()
    try:
        RaftNode.tick = counted_tick
        doc, secs, n = soak("a", "--seed", "7", "--ticks", "120")
        launches += n
        if doc["timeline_canonical"] != committed:
            raise AssertionError("[chaos] (a): the planned timeline differs "
                                 "from artifacts/chaos_soak_cpu_000.json")
        ph = doc["phases"]
        soak_step = ((ph["soak done"]["t_s"] - ph["planned"]["t_s"])
                     / ph["soak done"]["ticks"])
        log(f"[chaos] (a) kv, seed 7, 120 ticks: linearizable "
            f"({len(doc['history'])} history events; acknowledged per "
            f"client {kv_counts('a', doc)}); timeline == the committed "
            f"CPU artifact's, byte for byte ({len(committed)} bytes); "
            f"{len(doc['applied'])} events applied; conductor step "
            f"{doc['step_ms']:.1f} ms calibrated (admission target "
            f"{doc['admission_target_ms']:.1f} ms), {soak_step * 1e3:.1f} "
            f"ms under the load; {secs:.1f}s, "
            f"{n} launches in {n} node ticks")

        doc, secs, n = soak("b", "--seed", "3", "--ticks", "100",
                            "--stale-reads")
        launches += n
        if doc["verdict"]["ok"] or not doc["verdict"]["counterexample"]:
            raise AssertionError("[chaos] (b): the stale reads were missed")
        log(f"[chaos] (b) --stale-reads, seed 3, 100 ticks: the checker "
            f"caught the injected defect on key {doc['verdict']['key']} "
            f"({len(doc['verdict']['counterexample'])}-op "
            f"counterexample); {secs:.1f}s, {n} launches in {n} node ticks")

        doc, secs, n = soak("c", "--seed", "7", *CHAOS_ISOLATE_ARGS,
                            "--nemesis", "leader-isolate")
        launches += n
        win = doc["recovery_windows"]
        if doc["checkquorum_stepdowns"] < 1 or not win:
            raise AssertionError(f"[chaos] (c) vacuous: {win}")
        log(f"[chaos] (c) leader-isolate, seed 7, "
            f"{' '.join(CHAOS_ISOLATE_ARGS)}, CheckQuorum on, conductor "
            f"step {doc['step_ms']:.1f} ms calibrated: {len(win)} cut(s), "
            f"goodput back "
            + ", ".join(f"{w['first_ok_tick'] - w['cut_tick']} ticks"
                        for w in win)
            + f" after the cut (budget 60, cut open 70); CheckQuorum "
            f"step-downs {doc['checkquorum_stepdowns']}; linearizable "
            f"(acknowledged per client {kv_counts('c', doc)}); "
            f"{secs:.1f}s, {n} launches in {n} node ticks")

        doc, secs, n = soak("d", "--workload", "transfer", "--seed", "17",
                            "--ticks", str(CHAOS_TRANSFER_TICKS),
                            "--clients", "12")
        launches += n
        rep = doc["verdict"]["report"]
        if rep.get("committed", 0) < 1:
            raise AssertionError(f"[chaos] (d) vacuous: {rep}")
        log(f"[chaos] (d) transfer, seed 17, 12 clients, one round of "
            f"{CHAOS_TRANSFER_TICKS} ticks: check_transfer_atomicity "
            f"holds: {doc['workload']}, "
            f"coordinator ledger {rep}; no stranded intent; {secs:.1f}s, "
            f"{n} launches in {n} node ticks")
    finally:
        RaftNode.tick = orig_tick
        _artifact.ARTIFACT_DIR = art0
        shutil.rmtree(root, ignore_errors=True)
    kern = _kernel_entry("quorum_commit[chaos]", launches)
    log(f"[chaos] four soaks in {time.perf_counter() - t_phase:.1f}s; "
        f"quorum_commit {launches} launches in as many node ticks, "
        f"{_kernel_line(kern)}")
    return kern


# [config4]: BASELINE.json configs[3]'s partition scenario through the
# port's twin of tools/validate_config4.py, at full size on the card.
CONFIG4_GROUPS = 100_000


def phase_config4() -> dict:
    from rafting_tpu_torch.ops import quorum
    from rafting_tpu_torch.tools.validate_config4 import run_config4

    t_phase = time.perf_counter()
    quorum.reset_launch_counts()
    plog, c = run_config4(CONFIG4_GROUPS, "cuda")
    launches = _launches("config4")
    windows = [p for p in plog.phases if p["phase"] == "partitioned"]
    ticks = 60 + 30 * len(windows) + 75
    if launches != ticks:
        raise AssertionError(f"[config4] quorum kernel launched {launches} "
                             f"times in {ticks} ticks (want one per tick)")
    kern = _kernel_entry("quorum_commit[config4]", launches)
    elect, healed = plog.phases[0], plog.phases[-1]
    pct = ", ".join(f"{p['ticks']}: {p['progressed_pct']}% "
                    f"({p['ms_per_tick']:.3f} ms/tick)" for p in windows)
    log(f"[config4] BASELINE configs[3]: {CONFIG4_GROUPS} groups x 5 nodes, "
        f"debug checks on, seed 4: elect+replicate {elect['elapsed_s']:.3f}"
        f"s ({elect['ms_per_tick']:.3f} ms/tick, {elect['committed']} "
        f"committed); partition {{0,1,2}} | {{3,4}}, majority-side groups "
        f"progressed after partitioned ticks {pct}; healed: "
        f"{healed['commits_after_heal']} commits after the heal, "
        f"{healed['committed']} in all "
        f"({healed['ms_per_tick']:.3f} ms/tick), no same-term split brain "
        f"at any tick; {time.perf_counter() - t_phase:.1f}s; quorum_commit "
        f"{launches} launches, {_kernel_line(kern)}")
    del c
    return kern


# [shard]: the cluster sharded over torch.distributed through the twin of
# __graft_entry__.dryrun_multichip, at 32,768 groups x 4 nodes for 64
# ticks: world 1 over NCCL (mesh 1 x 1, in this process) and world 4 over
# gloo on this one card (mesh 2 node x 2 group, four spawned ranks, every
# collective staged through host tensors).  Each gathered result must be
# the unsharded run's on the card, lane for lane.  One card proves the
# sharded path right; no multi-GPU rate comes from it.
SHARD_GROUPS, SHARD_NODES = 32_768, 4


def _same_tree(want, got, path: str) -> None:
    if isinstance(want, dict):
        for k in want:
            _same_tree(want[k], got[k], f"{path}.{k}")
        return
    if want is None:
        if got is not None:
            raise AssertionError(f"{path}: None against a tensor")
        return
    if want.shape != got.shape or want.dtype != got.dtype \
            or not np.array_equal(want, got):
        raise AssertionError(f"{path}: sharded != unsharded")


def phase_shard() -> list:
    from rafting_tpu_torch.bridge import state_to_numpy
    from rafting_tpu_torch.core.sim import run_cluster_ticks
    from rafting_tpu_torch.tools import dryrun_multichip as dm

    t_phase = time.perf_counter()
    job = dm.dryrun_job((1, 1), SHARD_NODES, SHARD_GROUPS)
    T = job["ticks"]
    cfg, full = dm.full_cluster(job, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_cluster_ticks(cfg, T, *full, device="cuda")
    torch.cuda.synchronize()
    ref_ms = (time.perf_counter() - t0) / T * 1e3
    want = [state_to_numpy(t) for t in out]
    del full, out
    runs, kerns = {}, []
    for world, backend, mesh, name in (
            (1, "nccl", (1, 1), "quorum_commit[shard]"),
            (4, "gloo", (2, 2), "quorum_commit[shard-w4]")):
        res = dm.dryrun(world, backend, "cuda", mesh, SHARD_NODES,
                        SHARD_GROUPS)
        r0 = res["ranks"][0]
        for k, part in enumerate(("state", "inflight", "info")):
            _same_tree(want[k], r0[part], f"[shard] world {world} {part}")
        for r in res["ranks"]:
            if r["launches"] != T or r["strided"]:
                raise AssertionError(
                    f"[shard] world {world} rank {r['rank']}: "
                    f"{r['launches']} launches ({r['strided']} strided) in "
                    f"{T} ticks (want one dense launch a tick)")
        # Rank 0's last launch, dense as it ran (no strided launch), on
        # this card; the ranks counted their own launches around the run.
        _TICK_OPERANDS[0] = tuple(torch.from_numpy(a).cuda()
                                  for a in r0["operands"])
        kerns.append(_kernel_entry(name, r0["launches"]))
        runs[world] = res
    desc = "; ".join(
        f"world {w} over {r['backend']}, mesh ({r['mesh'][0]} node x "
        f"{r['mesh'][1]} group), committed {r['committed']}, ranks "
        + ", ".join(f"{x['coords']} local {x['local_term']} "
                    f"{x['ms_per_tick']:.3f} ms/tick {x['launches']} "
                    f"launches" for x in r["ranks"])
        for w, r in runs.items())
    log(f"[shard] {SHARD_GROUPS} groups x {SHARD_NODES} nodes, "
        f"{T} ticks; unsharded on this card {ref_ms:.3f} ms/tick (the "
        f"tick loop alone, as each rank times it); {desc}; both gathered "
        f"runs equal the unsharded one on every lane; "
        f"{time.perf_counter() - t_phase:.1f}s; "
        + "; ".join(f"{k['name']} {k['launches']} launches per rank, "
                    f"{_kernel_line(k)}" for k in kerns))
    return kerns


# [stages]: bench.py's last five stages through the twin
# (rafting_tpu_torch/tools/bench.py), in this process: the member child at
# full width (100k groups, P = 3 A/B, then the P = 6 walk), one runtime run
# with the whole attribution plane on (1/64 span sampling, heat lanes, hop
# tracing) and one with it off at the [bench] runtime scale, 2 rounds each
# (a run's set-up takes most of its time, and the smoke gates no rate), the
# open-loop sweep at its 8 groups and the txn stage at 3 groups, both with
# shorter phases (STAGES_ENV).  Correctness gates here; the member ratio
# and the no-collapse plateau are printed as met or missed, and the CLI
# asserts them with the planes' 2% budgets (one pair of runs at this size
# sits inside its own noise, so no overhead is printed).
STAGES_MEMBER_GROUPS = 100_000
STAGES_RT_GROUPS = BENCH_RT_GROUPS
STAGES_RT_ROUNDS = 2
STAGES_ENV = {"BENCH_OPENLOOP_DUR": "1", "BENCH_TXN_GROUPS": "3",
              "BENCH_TXN_DUR": "2"}


def _stage_lines(fn, *args, **kw):
    """Run one bench stage with its JSON lines logged under [stages]."""
    import contextlib
    import io
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            return fn(*args, **kw)
    finally:
        for ln in buf.getvalue().splitlines():
            log(f"[stages] {ln}")


def _met(ok: bool) -> str:
    return "met" if ok else "missed"


def phase_stages() -> dict:
    import tempfile
    from rafting_tpu_torch.ops import quorum
    from rafting_tpu_torch.tools import _artifact, bench

    t_phase = time.perf_counter()
    G = STAGES_MEMBER_GROUPS
    art_dir = tempfile.mkdtemp(prefix="stages-artifacts-")
    old_art, _artifact.ARTIFACT_DIR = _artifact.ARTIFACT_DIR, art_dir
    old_env = {k: os.environ.get(k) for k in STAGES_ENV}
    os.environ.update(STAGES_ENV)
    try:
        # (a) The member child: the kernel against the fixed-majority
        # baseline at P = 3, then the 3 -> 3-disjoint walk at P = 6.  The
        # first walk chunk's last launch lies inside the joint window (its
        # nodes hold C_old,new or C_new): its operands are kept for a
        # second kernel entry.
        quorum.reset_launch_counts()
        marks = {}

        def on_step(label, _cluster):
            n = quorum.launch_counts["quorum_commit"]
            if label == "catch-up":
                marks["joint_from"] = n
            elif label == "walk":
                marks["joint_to"] = n
                if "joint" not in marks and _TICK_OPERANDS[0] is not None:
                    marks["joint"] = tuple(a.clone()
                                           for a in _TICK_OPERANDS[0])

        t0 = time.perf_counter()
        res, walk = _stage_lines(bench.member_run, G, check=False,
                                 on_step=on_step)
        member_s = time.perf_counter() - t0
        launches = _launches("stages-member")
        want = 32 + 2 * 64 + walk["ticks"]
        if launches != want:
            raise AssertionError(
                f"[stages] member: quorum kernel launched {launches} times "
                f"(want {want}: one per tick of the masked run and of the "
                f"walk, none in the fixed-majority run)")
        kern = _kernel_entry("quorum_commit[member]", launches)
        if "joint" not in marks:
            raise AssertionError("[stages] member: no kernel launch in the "
                                 "joint window")
        joint_lanes = int((marks["joint"][6] != 0).sum())
        if not joint_lanes:
            raise AssertionError("[stages] member: the joint window's "
                                 "launch had no C_new lane")
        _TICK_OPERANDS[0] = marks.pop("joint")
        kern_joint = _kernel_entry("quorum_commit[member-joint]",
                                   marks["joint_to"] - marks["joint_from"])
        for k in (kern, kern_joint):
            if k["shape"] != [6, G, 6]:
                raise AssertionError(f"[stages] member: {k['name']} ran "
                                     f"{k['shape']}, want [6, {G}, 6]")
        ratio = res["masked_vs_fixed"]
        walk_ticks = 2 + 48 + 16 * walk["chunks"]
        log(f"[stages] {json.dumps(res)}")
        log(f"[stages] member {G} groups: P=3 fixed-majority "
            f"{res['cps_fixed']:.0f} commits/s, kernel "
            f"{res['cps_masked']:.0f} ({ratio}x; bench.py's >= 0.95 "
            f"{_met(ratio >= 0.95)}); P=6 walk converged in "
            f"{walk['chunks']} chunks, {res['walk_groups_per_sec']:.0f} "
            f"groups/s ({walk['elapsed_s']:.3f} s, "
            f"{walk['elapsed_s'] / walk_ticks * 1e3:.3f} ms/tick over "
            f"{walk_ticks} ticks); no committed entry lost (post - pre "
            f">= {int((walk['post'] - walk['pre']).min())}), commits "
            f"resumed (+{int((walk['resume'] - walk['post']).min())} at "
            f"least); peak device memory "
            f"{walk['peak_bytes'] / 2**30:.3f} GiB; {member_s:.1f}s; "
            f"quorum_commit {launches} launches ({walk['launches']}), "
            f"last launch {_kernel_line(kern)}; joint window "
            f"{kern_joint['launches']} launches, first walk chunk's last "
            f"launch ({joint_lanes} lanes with C_new) "
            f"{_kernel_line(kern_joint)}")

        # (b) The latency and attribution planes: one bench_runtime run
        # with all of it pinned on, one with all of it pinned off.
        from rafting_tpu_torch.tools import bench_runtime
        quorum.reset_launch_counts()
        t0 = time.perf_counter()
        on = bench_runtime.run(STAGES_RT_GROUPS, rounds=STAGES_RT_ROUNDS,
                               lat_sample=64, heat=True, hops=True)
        off = bench_runtime.run(STAGES_RT_GROUPS, rounds=STAGES_RT_ROUNDS,
                                lat_sample=0, heat=False, hops=False)
        rt_launches = _launches("stages-planes")
        hops = on["hops"]
        if (on["latency"]["sample_rate"] != 64
                or off["latency"]["sample_rate"] != 0
                or not on["heat"]["enabled"] or off["heat"]["enabled"]
                or not hops["enabled"] or off["hops"]["enabled"]):
            raise AssertionError(
                f"[stages] planes: the pins did not take (sample rate "
                f"{on['latency']['sample_rate']} / "
                f"{off['latency']['sample_rate']}, heat "
                f"{on['heat']['enabled']} / {off['heat']['enabled']}, hops "
                f"{hops['enabled']} / {off['hops']['enabled']})")
        if (not on["heat"].get("active_set") or not rt_launches
                or not hops["hop_requests_sent"]
                or not hops["hop_finalized"]):
            raise AssertionError(
                f"[stages] planes: heat active set "
                f"{on['heat'].get('active_set')}, hop counters {hops}, "
                f"{rt_launches} kernel launches")
        log(f"[stages] planes at {STAGES_RT_GROUPS} groups x "
            f"{STAGES_RT_ROUNDS} rounds: pins took (sample rate 64 / 0, "
            f"heat and hops on / off); attributed run {on['value']} durable "
            f"commits/s, bare run {off['value']}; heat active set "
            f"{on['heat']['active_set']}, hop counters {hops}; "
            f"{time.perf_counter() - t0:.1f}s; quorum_commit {rt_launches} "
            f"launches")

        # (c) The open-loop sweep, admission on and then off.
        quorum.reset_launch_counts()
        t0 = time.perf_counter()
        ol = _stage_lines(bench.run_openloop_stage, "", check=False)
        ol_launches = _launches("stages-openloop")
        on = ol["sweep"]["on"]
        acked = sum(d["ok"] for d in on)
        if not acked or not ol_launches:
            raise AssertionError(f"[stages] open loop: admission on acked "
                                 f"{acked}, {ol_launches} kernel launches")
        log(f"[stages] open loop at {ol['scale']} groups: capacity "
            f"{ol['capacity']} ops/s; admission on goodput "
            + ", ".join(f"{d['offered_x_capacity']:g}x {d['goodput']}"
                        for d in on)
            + "; off " + ", ".join(f"{d['offered_x_capacity']:g}x "
                                   f"{d['goodput']}"
                                   for d in ol["sweep"]["off"])
            + f" ops/s; {acked} acked with admission on; no-collapse "
            f"plateau {_met(ol['no_collapse']['ok'])} "
            f"({ol['no_collapse']['why']}); "
            f"{time.perf_counter() - t0:.1f}s; quorum_commit {ol_launches} "
            f"launches")

        # (d) Cross-group 2PC transfers against independent writes.
        quorum.reset_launch_counts()
        t0 = time.perf_counter()
        (tx,) = _stage_lines(bench.run_txn_stage, "")
        tx_launches = _launches("stages-txn")
        if not tx["txn"]["ok"] > 0 or not tx_launches:
            raise AssertionError(f"[stages] txn: {tx['txn']}, "
                                 f"{tx_launches} kernel launches")
        log(f"[stages] txn at {tx['scale']} groups, {tx['clients']} "
            f"clients: {tx['txn_per_sec']} txn/s ({tx['txn']}), abort rate "
            f"{tx['abort_rate']}, independent writes "
            f"{tx['independent_pairs_per_sec']} pairs/s, atomicity tax "
            f"{tx['atomicity_tax']}; {time.perf_counter() - t0:.1f}s; "
            f"quorum_commit {tx_launches} launches")
    finally:
        for k, v in old_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        _artifact.ARTIFACT_DIR = old_art
        shutil.rmtree(art_dir, ignore_errors=True)
    log(f"[stages] all five stages passed their gates in "
        f"{time.perf_counter() - t_phase:.1f}s")
    return [kern, kern_joint]


def _profile(label: str, tick, neighbours: bool = False,
             per_call: int = 1) -> None:
    """8 ticks of ``tick()`` (8 calls of ``per_call`` ticks each) under
    torch.profiler: the top kernels by device time and the device-busy
    share of the wall time, per tick; with ``neighbours``, the kernels
    next to each qc_kernel.  Only the first profiler session of a process
    records kernels on the H100 machine (PERF.md §6), so that check goes
    with the first call."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    T = 8 * per_call
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(8):
            tick()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    launches = sum(e.count for e in rows)
    log(f"[profile {label}] {T} ticks: wall {wall / T * 1e3:.3f} ms/tick, "
        f"device busy {busy / T * 1e3:.3f} ms/tick ({busy / wall:.1%} of "
        f"wall), {launches / T:.0f} device ops/tick")
    for e in rows[:10] + [e for e in rows if "qc_kernel" in e.key]:
        log(f"[profile {label}]   {e.self_device_time_total / T:9.1f} "
            f"us/tick {e.count / T:6.1f}/tick  {e.key[:70]}")
    if not neighbours:
        return
    # The kernels the device ran on either side of each qc_kernel: the
    # launcher copies nothing, so no copy kernel sits next to it.
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(os.path.join(d, "trace.json"))
        with open(os.path.join(d, "trace.json")) as f:
            kern = sorted((e for e in json.load(f)["traceEvents"]
                           if e.get("cat") == "kernel"),
                          key=lambda e: e["ts"])
    names = [e["name"] for e in kern]
    at = [i for i, n in enumerate(names) if "qc_kernel" in n]
    if not at:
        raise AssertionError(f"[profile {label}] no qc_kernel in the trace")
    near = [names[j] for i in at for j in (i - 1, i + 1)
            if 0 <= j < len(names)]
    copies = [n for n in near if "copy" in n.lower()]
    log(f"[profile {label}] {len(at)} qc_kernel launches; the kernels next "
        f"to the first: {[n[:60] for n in names[max(at[0] - 2, 0):at[0]]]} "
        f"before, {[n[:60] for n in names[at[0] + 1:at[0] + 2]]} after; "
        f"copy kernels next to any: {len(copies)}")
    if copies:
        raise AssertionError(f"[profile {label}] a copy kernel next to "
                             f"qc_kernel: {copies[:3]}")


def phase_profile() -> None:
    """``--profile`` only: where a tick's device time goes on each path —
    8 steady headline ticks, 32 ticks of the bench ladder's blocked 100k
    point, then 8 nemesis ticks inside the split-brain window (all four
    optional subtrees on)."""
    from rafting_tpu_torch import (
        DeviceCluster, EngineConfig, run_cluster_ticks_blocked,
        run_cluster_ticks_nemesis,
    )
    from rafting_tpu_torch.core.types import tree_map
    from rafting_tpu_torch.testkit import nemesis
    cfg = EngineConfig(n_groups=100_000, n_peers=3)
    c = DeviceCluster(cfg, seed=0, device="cuda")
    for _ in range(60):
        c.tick(submit_n=cfg.max_submit)
    _profile("headline", lambda: c.tick(submit_n=cfg.max_submit),
             neighbours=True)

    # The bench ladder's 100k point, from the same state: 4 blocks of
    # 25,000 groups through run_cluster_ticks_blocked, 4 ticks a call
    # (the ladder's calls are 32 ticks; each call splits and merges the
    # state once).
    load = torch.full((cfg.n_peers, cfg.n_groups), cfg.max_submit,
                      dtype=torch.int32, device="cuda")

    def blocked_ticks():
        c.states, c.inflight, c.last_info = run_cluster_ticks_blocked(
            cfg, 4, c.states, c.inflight, c.last_info, c.conn, load,
            BENCH_BLOCKS[1], device="cuda")

    for _ in range(2):
        blocked_ticks()
    _profile("bench-blocked", blocked_ticks, per_call=4)
    del c

    cfg = nemesis_cfg()
    c = DeviceCluster(cfg, seed=0, device="cuda")
    sched = nemesis.concat(nemesis.healthy(cfg.n_peers, 50, "cuda"),
                           nemesis.chaos_mix(cfg.n_peers, 150, seed=0,
                                             device="cuda"))
    load = torch.full((cfg.n_peers, cfg.n_groups), cfg.max_submit,
                      dtype=torch.int32, device="cuda")
    states, inflight, info, t = c.states, c.inflight, c.last_info, 0

    def tick():
        nonlocal states, inflight, info, t
        states, inflight, info = run_cluster_ticks_nemesis(
            cfg, states, inflight, info,
            tree_map(lambda a: a[t:t + 1], sched), load, device="cuda")
        t += 1

    for _ in range(64):      # warm-up, then into the split (ticks 62..87)
        tick()
    _profile("nemesis", tick)


def _timed(phase):
    """Run one phase; log its wall time and this process's memory."""
    t0 = time.perf_counter()
    out = phase()
    log(f"[time] {phase.__name__[6:]} {time.perf_counter() - t0:.1f}s; "
        f"[mem] {_mem()}")
    return out


def main() -> int:
    sys.path.insert(0, HERE)
    t0 = time.perf_counter()
    card = phase_probe()
    _capture_tick_operands()
    if "--profile" in sys.argv[1:]:
        for p in (phase_build, phase_kernel, phase_profile):
            _timed(p)
        print(card)
        return 0
    for phase in (phase_build, phase_kernel, phase_parity,
                  phase_parity_nemesis):
        _timed(phase)
    kernels = [_timed(phase_main), _timed(phase_bench),
               _timed(phase_nemesis)]
    _timed(phase_runtime_parity)
    kernels.append(_timed(phase_runtime))
    _release_host_memory()
    log(f"[mem] released: {_mem()}")
    _timed(phase_api_testnode)
    for phase in (phase_api_1k, phase_oracle, phase_snapshot, phase_chaos,
                  phase_config4):
        kernels.append(_timed(phase))
    kernels += _timed(phase_shard)
    kernels += _timed(phase_stages)
    log(f"[time] whole script {time.perf_counter() - t0:.1f}s")
    for k in kernels:
        del k["bytes"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
