"""Quorum-commit order statistic and read barrier — phase 10 and 8b ops.

The counterpart of ``rafting_tpu/ops/quorum.py``.  For every Raft group at
once, the leader's commit advancement generalized to the §6 membership
plane: the masked majority order statistic of the match matrix over the
voter bitmask (joint: the min over both voter sets), the commit-only-
own-term rule as ``q >= own_from``, the full-replication lane (min over
voter slots) and the masked monotone update of ``commit``.

Every function takes any number of leading axes: the batched step passes
``[N, G, P]`` match rows and ``[N, G]`` lanes.

``quorum_commit`` dispatches by device: a CUDA tensor goes to the
hand-written kernel (``csrc/quorum_commit.cu``, one launch per tick for
the whole cluster); a CPU tensor goes to the plain version
:func:`quorum_commit_ref`.  ``cfg.quorum_fixed`` keeps its bench-only
meaning (the legacy fixed-majority baseline, plain torch).
"""

from __future__ import annotations

import threading

import torch

I32 = torch.int32
_I32_MAX = (1 << 31) - 1

# Kernel launches, counted where each wrapper launches its kernel.  Several
# nodes tick from their own threads in one process, so the count takes a
# lock.
launch_counts = {"quorum_commit": 0}
_count_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for k in launch_counts:
            launch_counts[k] = 0


def _count_launch(name: str) -> None:
    with _count_lock:
        launch_counts[name] += 1


def _bits(mask: torch.Tensor, P: int) -> torch.Tensor:
    """[...] peer bitmask -> [..., P] bool."""
    p = torch.arange(P, dtype=I32, device=mask.device)
    return ((mask.unsqueeze(-1) >> p) & 1) > 0


def masked_order_stat(match: torch.Tensor, bits: torch.Tensor
                      ) -> torch.Tensor:
    """Majority order statistic of ``match`` [..., P] over ``bits``
    [..., P]: the largest x such that at least popcount//2+1 of the masked
    slots hold match >= x.  Non-members become -1; an empty mask yields
    -1.  The position select is a static where-chain, as in the
    reference."""
    P = match.shape[-1]
    sm = torch.sort(torch.where(bits, match, torch.full_like(match, -1)),
                    dim=-1).values
    nv = bits.sum(dim=-1).to(I32)
    pos = torch.clamp(P - (nv // 2 + 1), 0, P - 1)
    q = sm[..., 0]
    for p in range(1, P):
        q = torch.where(pos == p, sm[..., p], q)
    return q


def quorum_commit_ref(match_full, own_from, last, commit, can_lead,
                      voters, voters_new) -> torch.Tensor:
    """Plain version of the quorum-commit kernel (phase 10)."""
    P = match_full.shape[-1]
    vb = _bits(voters, P)
    q = masked_order_stat(match_full, vb)
    nb = _bits(voters_new, P)
    qn = masked_order_stat(match_full, nb)
    joint = voters_new != 0
    q = torch.where(joint, torch.minimum(q, qn), q)
    full = torch.where(vb | nb, match_full,
                       torch.full_like(match_full, _I32_MAX)).amin(dim=-1)
    can = can_lead & (q > commit) & (q >= own_from) & (q <= last)
    can_full = can_lead & (full > commit) & (full <= last)
    return torch.maximum(torch.where(can, q, commit),
                         torch.where(can_full, full, commit))


def quorum_commit_fixed(cfg, match_full, last, commit, own_from, can_lead
                        ) -> torch.Tensor:
    """The legacy fixed-majority baseline (bench A/B only; valid only
    while every group holds the boot full-voter config)."""
    P = match_full.shape[-1]
    if P == 3 and cfg.majority == 2:
        a, b, c = match_full[..., 0], match_full[..., 1], match_full[..., 2]
        quorum_idx = torch.maximum(torch.minimum(a, b),
                                   torch.minimum(torch.maximum(a, b), c))
        full_idx = torch.minimum(torch.minimum(a, b), c)
    else:
        sorted_m = torch.sort(match_full, dim=-1).values
        quorum_idx = sorted_m[..., P - cfg.majority]
        full_idx = sorted_m[..., 0]
    can = can_lead & (quorum_idx > commit) & \
        (quorum_idx >= own_from) & (quorum_idx <= last)
    can_full = can_lead & (full_idx > commit) & (full_idx <= last)
    return torch.maximum(torch.where(can, quorum_idx, commit),
                         torch.where(can_full, full_idx, commit))


def quorum_commit_cuda(match_full, own_from, last, commit, can_lead,
                       voters, voters_new) -> torch.Tensor:
    """Launch the CUDA quorum-commit kernel (same arguments and result
    as :func:`quorum_commit_ref`).  One thread per lane over all leading
    axes; raises on a tensor the kernel does not take, on a build failure
    and on a launch error."""
    from . import _build

    P = match_full.shape[-1]
    lanes = match_full.shape[:-1]
    dev = match_full.device
    if dev.type != "cuda":
        raise ValueError("quorum_commit_cuda needs CUDA tensors")
    if not 1 <= P <= 10:
        raise ValueError(f"quorum_commit_cuda supports 1..10 peers, got {P}")
    args = {"match_full": (match_full, I32, match_full.shape),
            "own_from": (own_from, I32, lanes), "last": (last, I32, lanes),
            "commit": (commit, I32, lanes),
            "can_lead": (can_lead, torch.bool, lanes),
            "voters": (voters, I32, lanes),
            "voters_new": (voters_new, I32, lanes)}
    for name, (t, dtype, shape) in args.items():
        if t.device != dev or t.dtype != dtype or t.shape != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"quorum_commit_cuda: {name} must be a contiguous {dtype} "
                f"tensor of shape {tuple(shape)} on {dev}; got "
                f"{t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    lib = _build.load("quorum_commit")
    out = torch.empty(lanes, dtype=I32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.qc_launch(P, match_full.data_ptr(), own_from.data_ptr(),
                        last.data_ptr(), commit.data_ptr(),
                        can_lead.data_ptr(), voters.data_ptr(),
                        voters_new.data_ptr(), out.data_ptr(), out.numel(),
                        stream)
    if err != 0:
        raise RuntimeError(f"quorum_commit kernel launch failed: CUDA "
                           f"error {err}")
    _count_launch("quorum_commit")
    return out


def quorum_commit(cfg, match_full, log, commit, own_from, can_lead,
                  voters, voters_new):
    """Dispatch: the fixed-majority baseline when ``cfg.quorum_fixed``
    (bench A/B only); the CUDA kernel for CUDA tensors; the plain version
    for CPU tensors."""
    if getattr(cfg, "quorum_fixed", False):
        return quorum_commit_fixed(cfg, match_full, log.last, commit,
                                   own_from, can_lead)
    if match_full.is_cuda:
        # The kernel reads the lanes as stored; the step's lanes may come
        # out of torch.where with transposed strides, so lay them out.
        return quorum_commit_cuda(*(t.contiguous() for t in (
            match_full, own_from, log.last, commit, can_lead, voters,
            voters_new)))
    return quorum_commit_ref(match_full, own_from, log.last, commit,
                             can_lead, voters, voters_new)


def read_barrier_release(voters, voters_new, me, read_evid, rq_stamp,
                         rq_head, rq_len, rq_n):
    """ReadIndex barrier for every group at once: how many pending read
    batches (FIFO from ``rq_head``) have a confirmed leadership quorum
    (self plus peers with ``read_evid >= stamp`` covering a majority of
    the voters, and of voters_new while joint).

    Shapes: ``read_evid`` [..., G, P], ``rq_*`` [..., G, K], ``voters``
    [..., G]; ``me`` holds the leading axes only (a scalar for one node,
    [N] for the batched step).  Returns ``(n_rel, n_served)``, int32
    [..., G]."""
    K = rq_stamp.shape[-1]
    P = read_evid.shape[-1]
    dev = rq_stamp.device
    j = torch.arange(K, dtype=I32, device=dev)                  # FIFO pos
    slot = torch.remainder(rq_head.unsqueeze(-1) + j, K).long()  # [..., G, K]
    st = torch.gather(rq_stamp, -1, slot)
    n = torch.gather(rq_n, -1, slot)
    pending = j < rq_len.unsqueeze(-1)
    self_hot = torch.arange(P, dtype=I32, device=dev) == \
        me.reshape(me.shape + (1, 1, 1))                       # [..., 1, 1, P]
    flags = (read_evid.unsqueeze(-2) >= st.unsqueeze(-1)) | self_hot
    vb = _bits(voters, P).unsqueeze(-2)
    nb = _bits(voters_new, P).unsqueeze(-2)
    ok_v = (flags & vb).sum(dim=-1) >= vb.sum(dim=-1) // 2 + 1
    ok_n = (flags & nb).sum(dim=-1) >= nb.sum(dim=-1) // 2 + 1
    ok = pending & ok_v & ((voters_new == 0).unsqueeze(-1) | ok_n)
    rel = pending & (torch.cumsum((~ok).to(I32), dim=-1) == 0)
    return (rel.sum(dim=-1).to(I32),
            (rel.to(I32) * n).sum(dim=-1).to(I32))


def contact_quorum(voters, voters_new, me, heard, since):
    """CheckQuorum contact test for every group at once: has a majority of
    the voters — and, while joint, of ``voters_new`` too — been heard from
    at or after the window anchor ``since``?  Self always counts; learner
    contact never does.

    Shapes: ``heard`` [..., G, P], ``since``/``voters`` [..., G]; ``me``
    holds the leading axes only (a scalar for one node, [N] for the
    batched step).  Returns [..., G] bool."""
    P = heard.shape[-1]
    self_hot = torch.arange(P, dtype=I32, device=heard.device) == \
        me.reshape(me.shape + (1, 1))                          # [..., 1, P]
    flags = (heard >= since.unsqueeze(-1)) | self_hot          # [..., G, P]
    vb = _bits(voters, P)
    nb = _bits(voters_new, P)
    ok_v = (flags & vb).sum(dim=-1) >= vb.sum(dim=-1) // 2 + 1
    ok_n = (flags & nb).sum(dim=-1) >= nb.sum(dim=-1) // 2 + 1
    return ok_v & ((voters_new == 0) | ok_n)
