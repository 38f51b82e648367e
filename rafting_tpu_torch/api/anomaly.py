"""Exception taxonomy — the user-visible failure vocabulary.

Mirrors the reference's stackless anomaly set (support/anomaly/*.java,
support/RaftException.java:13-16): each condition a client can observe has
a distinct type so callers can route on it (redirect, back off, retry,
give up).  Python tracebacks are cheap, so these are ordinary exceptions;
the *taxonomy* is what's preserved.
"""

from __future__ import annotations

import re
from typing import Optional


class RaftError(Exception):
    """Base for all framework errors (reference RaftException)."""


# Retry-after hints travel inside the refusal MESSAGE (the forward wire
# carries only "REFUSED:TypeName: msg", transport/codec.py serve_forward),
# so the hint survives the relay without a codec change.
_RETRY_AFTER = re.compile(r"\[retry_after=([0-9.]+)s\]")


def retry_after_of(exc_or_msg) -> Optional[float]:
    """Extract a server-issued retry-after hint (seconds) from a refusal:
    the typed attribute when present, else the wire-format marker embedded
    in the message.  None = no hint (caller falls back to its own
    backoff)."""
    ra = getattr(exc_or_msg, "retry_after_s", None)
    if ra is not None:
        return float(ra)
    m = _RETRY_AFTER.search(str(exc_or_msg))
    return float(m.group(1)) if m else None


def as_refusal(exc: RaftError) -> RaftError:
    """Mark an exception as a pre-log REFUSAL: raised before the command
    could enter any log (the node's refusal taxonomy and queue-bound
    checks, all of which run before enqueue — plus the rejection sweep
    over queued-but-never-device-accepted submissions).  Only marked
    refusals are safe to retry elsewhere; an UNMARKED failure of the same
    type (e.g. the NotLeaderError aborting an accepted command on
    step-down) may still commit cluster-wide, and retrying it could
    double-apply.  The marker travels the forward wire as the REFUSED:
    prefix (transport/codec.py serve_forward)."""
    exc.refusal = True
    return exc


def is_refusal(exc: BaseException) -> bool:
    return bool(getattr(exc, "refusal", False))


class NotLeaderError(RaftError):
    """Submission refused: this node does not lead the group.  Carries the
    last known leader for client redirect (reference NotLeaderException,
    support/anomaly/NotLeaderException.java:11-27)."""

    def __init__(self, group, leader: Optional[int] = None):
        super().__init__(f"group {group}: not leader "
                         f"(hint: {leader if leader is not None else '?'})")
        self.group = group
        self.leader = leader


# Evacuation targets travel inside the refusal message like retry-after
# hints do, so the forward relay preserves them without a codec change.
_EVAC_TARGET = re.compile(r"\[target=(\d+)\]")


def evac_target_of(exc_or_msg) -> Optional[int]:
    """Extract a leadership-evacuation target hint from a refusal: the
    typed attribute when present, else the wire marker embedded in the
    message.  None = no target known."""
    t = getattr(exc_or_msg, "target", None)
    if t is not None:
        return int(t)
    m = _EVAC_TARGET.search(str(exc_or_msg))
    return int(m.group(1)) if m else None


class LeadershipEvacuatedError(NotLeaderError):
    """Submission refused: this node PROACTIVELY handed the group's
    leadership away because its own health scorecard crossed the
    degraded threshold (gray failure — slow disk, flapping NIC, shed
    storm; utils/health.py).  Beyond-reference: the reference's only
    step-down paths are higher-term discovery and the transfer RPC.

    Subclasses NotLeaderError so every existing redirect path keeps
    working; the distinct type + ``target`` tell clients this was a
    deliberate hand-off to a named healthy peer — re-point there in one
    hop (the leader mirror may lag the transfer), and don't count the
    refusal against this node's circuit breaker (api/retry.py: routing,
    not sickness).  The target rides the message as ``[target=N]`` so
    it survives the forward relay (``evac_target_of`` re-parses it)."""

    def __init__(self, group, leader: Optional[int] = None,
                 target: Optional[int] = None):
        super().__init__(group, leader)
        if target is not None:
            self.args = (f"group {group}: leadership evacuated "
                         f"(degraded node) [target={int(target)}]",)
            self.target: Optional[int] = int(target)
        else:
            self.args = (f"group {group}: leadership evacuated "
                         f"(degraded node) (hint: "
                         f"{leader if leader is not None else '?'})",)
            self.target = None


class NotReadyError(RaftError):
    """Leader exists but a majority of followers are unhealthy; refuse new
    commands rather than buffer unboundedly (reference NotReadyException +
    Leader.isReady quorum-health gate, context/member/Leader.java:52-64)."""


class BusyLoopError(RaftError):
    """Backpressure: the node's submission queue for the group is full,
    or storage backpressure (ENOSPC) paused admission (reference
    BusyLoopException, support/EventLoop.java:136-138).

    ``retry_after_s`` (optional) is the server's hint for how long the
    client should back off before retrying THIS node; it is embedded in
    the message so it survives the forward relay (``retry_after_of``
    parses it back out on the far side)."""

    def __init__(self, msg: str = "", retry_after_s: Optional[float] = None):
        if retry_after_s is not None and "[retry_after=" not in msg:
            # Not re-embedded when the marker already rides the message
            # (a wire_refusal rebuild re-parsing its own detail text).
            msg = f"{msg} [retry_after={float(retry_after_s):.3f}s]"
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class OverloadError(BusyLoopError):
    """Admission control shed this request: the node's offer queues have
    a standing delay above the CoDel-style target and the controller is
    load-shedding to keep admitted-request latency bounded
    (runtime/admission.py; beyond-reference — the reference's only
    admission story is Netty's unbounded channel queue).

    Always a MARKED pre-log refusal: the command never entered any
    queue, so retrying elsewhere — or here, after ``retry_after_s`` —
    can never double-apply.  Subclasses BusyLoopError so existing
    backpressure handlers treat shedding and queue-full uniformly."""


class StorageFaultError(RaftError):
    """The node's durable storage failed underneath this group: its WAL
    stripe is fail-stop quarantined (a failed fsync is never retried on
    the same fd — the page cache may have dropped the dirty pages, so a
    later "clean" fsync would be a lie).  The lane goes silent and a
    healthy replica takes over at the next election timeout.

    Marking: FRESH submissions refused with this error are marked
    retry-safe (they never entered any log); commands already accepted
    into the log fail with it UNMARKED — their entries may have been
    replicated before the fault, so the outcome is unknown (the same
    ambiguity BatchAbortedError documents).  Recovery: retry against the
    peer that wins the ensuing election."""


class UnavailableError(StorageFaultError):
    """This node cannot serve the group AT ALL right now — its WAL stripe
    is fail-stop quarantined (the lane is going silent so a healthy
    replica takes over).  Always a typed, immediate, MARKED pre-log
    refusal: fresh submits and reads targeting a quarantined stripe
    fast-fail with this instead of riding a future to its full timeout.
    Retrying against THIS node is futile until an operator replaces the
    disk; retry against the peer that wins the ensuing election.
    Subclasses StorageFaultError so storage-aware handlers keep working;
    the distinct type lets clients (and the stub's circuit breaker)
    route around the node instead of waiting out the ambiguity that
    plain StorageFaultError (outcome unknown) implies."""


class ObsoleteContextError(RaftError):
    """The group was closed or destroyed (reference
    ObsoleteContextException; Administrator lifecycle,
    command/admin/Administrator.java:123-154)."""


class WaitTimeoutError(RaftError):
    """A client wait elapsed before the command committed (reference
    WaitTimeoutException, support/Promise.java:23-32)."""


class RetryCommandError(RaftError):
    """A state machine asked for the apply to be retried later (reference
    RetryCommandException, support/anomaly/RetryCommandException.java:10-25)."""

    def __init__(self, delay_s: float = 0.05):
        super().__init__(f"retry after {delay_s}s")
        self.delay_s = delay_s


class SerializeError(RaftError):
    """Command (de)serialization failed (reference SerializeException)."""


class BatchAbortedError(RaftError):
    """A ``submit_batch`` future failed before every command in the batch
    resolved.  Carries per-slot outcomes so the client can see exactly
    which prefix already committed AND applied:

    * ``completed[k]`` True — command k committed and applied;
      ``results[k]`` holds its apply result.
    * ``completed[k]`` False — UNKNOWN: the command may still commit
      cluster-wide (the standard Raft client ambiguity on leader change —
      the same contract as a per-command NotLeader abort).  Blind
      resubmission can double-apply on a non-idempotent machine; re-check
      state or use idempotent/unique commands.

    ``cause`` is the underlying refusal (NotLeaderError, ObsoleteContext…).
    """

    def __init__(self, cause: Exception, results: list, completed: list):
        done = sum(1 for c in completed if c)
        super().__init__(
            f"batch aborted after {done}/{len(completed)} applied: {cause}")
        self.cause = cause
        self.results = results
        self.completed = completed


def wire_refusal(kind: str, detail: str) -> RaftError:
    """Rebuild a typed, MARKED refusal from the forward wire's
    ``REFUSED:TypeName: detail`` reply (transport/codec.py serve_forward)
    so the relay preserves the taxonomy end to end — retry-after hints
    included (they ride the detail text; the typed constructors re-parse
    them so ``retry_after_s`` is set on the rebuilt exception too).
    Unknown kinds come back as a marked bare RaftError (still refusal-
    marked: the serve side only stamps REFUSED on provably-pre-log
    failures)."""
    ra = retry_after_of(detail)
    if kind == "BusyLoopError":
        exc: RaftError = BusyLoopError(detail, retry_after_s=ra)
    elif kind == "OverloadError":
        exc = OverloadError(detail, retry_after_s=ra)
    elif kind == "NotReadyError":
        exc = NotReadyError(detail)
    elif kind == "LeadershipEvacuatedError":
        # Group context is unknown at this layer (the stub's wire parse
        # special-cases the kind with the lane in hand, like NotLeader);
        # the evacuation target still survives via the message marker.
        exc = LeadershipEvacuatedError("?", target=evac_target_of(detail))
    elif kind == "UnavailableError":
        exc = UnavailableError(detail)
    elif kind == "StorageFaultError":
        exc = StorageFaultError(detail)
    elif kind == "ObsoleteContextError":
        exc = ObsoleteContextError(detail)
    else:
        exc = RaftError(detail)
    return as_refusal(exc)
