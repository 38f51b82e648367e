"""Carry engine state across between the JAX package and the port.

``state_from_numpy`` builds the port's dataclasses (``RaftState``,
``Messages``, ``HostInbox``, ``StepInfo``, ``FaultSchedule``, and the
optional ``TraceState``/``HeatState``/``QuorumContact`` subtrees) from
the JAX pytrees after the
caller has turned them into numpy (``jax.tree.map(np.asarray, tree)``);
``state_to_numpy`` goes back to nested dicts of numpy arrays with the JAX
dtypes.  The JAX side is a nested dict, or any object with the same
attribute names.  This module never imports jax: the tests do the
``jax.tree`` -> numpy step themselves.  The only dtype that changes is the
PRNG key: uint32 on the JAX side, int64 holding the same words here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.types import (
    FaultSchedule, HeatState, HostInbox, LogState, Messages, QuorumContact,
    RaftState, StepInfo, TraceState, _Tree,
)

_KEY_FIELD = "rng"
# Fields that hold a nested container, by their container class.
_SUBTREES = {(RaftState, "log"): LogState, (RaftState, "trace"): TraceState,
             (RaftState, "heat"): HeatState, (RaftState, "qc"): QuorumContact}


def _get(tree, name):
    if isinstance(tree, dict):
        return tree.get(name)
    return getattr(tree, name, None)


def _infer_cls(tree):
    for cls, probe in ((RaftState, "node_id"), (Messages, "ae_valid"),
                       (StepInfo, "submit_start"), (HostInbox, "snap_done"),
                       (LogState, "base_term"), (FaultSchedule, "link_up"),
                       (TraceState, "kind"), (HeatState, "appended"),
                       (QuorumContact, "heard")):
        if _get(tree, probe) is not None:
            return cls
    raise TypeError("cannot tell which engine container this tree is")


def state_from_numpy(tree, device, cls=None):
    """JAX pytree of numpy arrays -> the port's dataclass on ``device``.
    A ``None`` optional subtree (trace/heat/qc, cq_*) stays ``None``."""
    cls = cls or _infer_cls(tree)
    kw = {}
    for f in dataclasses.fields(cls):
        v = _get(tree, f.name)
        sub = _SUBTREES.get((cls, f.name))
        if sub is not None and v is not None:
            kw[f.name] = state_from_numpy(v, device, sub)
        elif v is None:
            kw[f.name] = None
        else:
            a = np.asarray(v)
            if f.name == _KEY_FIELD:
                a = a.astype(np.int64)
            # np.array, not ascontiguousarray: that one turns 0-d into 1-d.
            kw[f.name] = torch.from_numpy(np.array(a, order="C")).to(device)
    return cls(**kw)


def state_to_numpy(state) -> dict:
    """The port's dataclass -> nested dict of numpy arrays in the JAX
    package's dtypes (the PRNG key back to uint32)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, _Tree):
            out[f.name] = state_to_numpy(v)
        elif v is None:
            out[f.name] = None
        else:
            a = v.detach().cpu().numpy()
            if f.name == _KEY_FIELD:
                a = a.astype(np.uint32)
            out[f.name] = a
    return out
