"""One node's device step, carried in static buffers and, on the card,
replayed as one CUDA graph.

The reference runs ``node_step`` as one compiled executable
(``@partial(jax.jit, static_argnums=0, donate_argnums=1)``,
rafting_tpu/core/step.py:225).  The port's step issues its ops one by
one: about 3,500 launches a tick, which on the card cost the tick thread
tens of milliseconds of host time while the card idles, and which three
nodes in one process pay in turn under the interpreter lock.  A node tick
longer than its ``tick_ms`` runs free instead of at the clock's pace, and
a leader that ticks faster than its follower counts out the 3-tick RPC
deadline before the reply comes.  :class:`NodeStepper` is the port's
counterpart of the jitted executable:

* the engine state lives in static tensors that the step overwrites in
  place (its last ops copy the next state into them), so one graph serves
  every tick.  ``node_step`` sees them with its explicit node axis, at
  N = 1 (``[1, G, ...]``); the node holds them as the reference's node
  holds its state, at ``[G]`` lanes: a tree of ``t[0]`` views built once,
  when the static state is allocated, so a replay updates what the node
  holds without a copy, and the node axis never leaves the stepper;
* the host inbox and the network inbox are packed on the host, widest
  dtype first, and land with ONE host->device copy (pinned,
  non-blocking) in a static buffer that the graph reads through views;
  one graph is captured for each layout of those lanes (the optional
  ``durable_tail`` lane makes two; ``layouts`` lists each capture's
  layout with the seconds it waited for the process-wide capture lock
  and the seconds the capture took);
* the outbox and the step info are the graph's own outputs (the node
  gets their row-0 views too), and so is one uint8 tensor packing what
  the node reads back (``fetch``): each holds a tick's values until the
  next ``step``, and the node reads them back, in one device->host copy,
  before it dispatches again;
* a leaf that is not the stepper's own view (the node replaced it with
  ``replace``: group lifecycle, lane purges) is copied into row 0 of its
  static tensor before the step runs, so the graph sees every such write
  without a new capture (``copied`` counts those leaves).

On the card the first step of a stepper runs the body uncaptured (it
loads the kernel library and warms the allocator), and each later step
replays the graph of its layout, captured at its first use.  The quorum
kernel's wrapper records its launch during the capture instead of
counting it (nothing runs then), and every replay counts the launches
its graph holds (``ops/quorum.py`` ``recording_launches``,
``count_replay``), so ``quorum.launch_counts`` still counts launches that
ran.  A capture that fails raises; nothing runs eagerly in its place.
On the CPU the same body runs uncaptured every tick: the same buffers,
copies and order.  ``close`` releases the graphs, their memory, the
static state and its views at a known point, once the node's tick thread
has stopped.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.step import node_step
from ..core.types import HostInbox, Messages, tree_map
from ..ops import quorum

_NP_OF = {torch.bool: np.bool_, torch.int32: np.int32}
_TORCH_OF = {np.dtype(v): k for k, v in _NP_OF.items()}

# One capture at a time in the process: several nodes tick from threads
# of their own, and each captures its first graphs on its tick thread.
# A closing node releases its graphs under the same lock, so no graph is
# destroyed while another node captures.
_CAPTURE_LOCK = threading.Lock()


def _leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def _row0(t: torch.Tensor) -> torch.Tensor:
    return t[0]


def pack_order(trees) -> tuple:
    """The tensor leaves of ``trees`` and the order they pack in (widest
    dtype first, so every host view stays aligned)."""
    leaves = [t for tree in trees for t in _leaves(tree)]
    return leaves, sorted(range(len(leaves)),
                          key=lambda i: -leaves[i].element_size())


def pack_leaves(trees) -> torch.Tensor:
    """Every tensor leaf of ``trees``, as the bytes of one uint8 tensor in
    ``pack_order``: what a node reads back in one copy."""
    leaves, order = pack_order(trees)
    return torch.cat([leaves[i].contiguous().view(-1).view(torch.uint8)
                      for i in order])


def to_host(trees, packed: Optional[torch.Tensor] = None) -> list:
    """Every tensor leaf of ``trees`` (state containers, tensors or None)
    as numpy, in containers of the same structure, through ONE
    device->host copy: of ``packed`` when the step already packed them
    (``pack_leaves(trees)``), else of their packing here."""
    leaves, order = pack_order(trees)
    if packed is None:
        packed = pack_leaves(trees)
    flat = packed.cpu().numpy()
    host: list = [None] * len(leaves)
    off = 0
    for i in order:
        t = leaves[i]
        n = t.numel() * t.element_size()
        host[i] = flat[off:off + n].view(_NP_OF[t.dtype]).reshape(t.shape)
        off += n
    it = iter(host)
    return [tree_map(lambda _: next(it), t) for t in trees]


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


class _Layout:
    """The static input buffer of one layout of the host lanes, its views
    (N = 1 node axis), and the graph captured on them with its outputs
    and recorded launches."""

    def __init__(self, items, device: torch.device):
        """``items``: (dict index, key, dtype, shape) of each lane, in
        packing order (the layout's key)."""
        self.key = items
        nbytes = sum(np.dtype(dt).itemsize * int(np.prod(shape))
                     for _, _, dt, shape in items)
        self.buf = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.views: list = [{}, {}]
        off = 0
        for i, k, dt, shape in items:
            n = np.dtype(dt).itemsize * int(np.prod(shape))
            self.views[i][k] = self.buf[off:off + n] \
                .view(_TORCH_OF[np.dtype(dt)]).reshape((1,) + shape)
            off += n
        self.graph: Optional["torch.cuda.CUDAGraph"] = None
        self.outs: Optional[tuple] = None
        self.launches: list = []


class NodeStepper:
    """``node_step`` at N = 1 for one node: see the module docstring.
    ``step(state, host_lanes, arrays)`` takes the node's state at ``[G]``
    lanes and returns ``(state, outbox, info, packed)``: ``node_step``'s
    result on those inputs without the node axis (the state is
    ``self.state``, the views of the static state), and
    ``pack_leaves(fetch(state, outbox, info))``, packed inside the step so
    that the node reads it back with one copy."""

    def __init__(self, cfg, device: torch.device, fetch, capture: bool):
        if capture and device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, not "
                             f"{device}")
        self.cfg = cfg
        self.device = device
        self.fetch = fetch
        self.capture = capture
        self._static = None          # [1, G] static state, from the first step
        self.state = None            # its row-0 views: what the node holds
        self._layouts: Dict[tuple, _Layout] = {}
        self._warm = False
        self._stream = torch.cuda.Stream(device) if capture else None
        self.captures = 0            # graphs captured
        self.lock_wait_s = 0.0       # host seconds waiting for the lock
        self.layouts: list = []      # (layout key, wait s, capture s) each
        self.replays = 0             # ticks that replayed a graph
        self.replay_s = 0.0          # host seconds inside those replays
        self.copied = 0              # leaves _adopt copied after the first

    # -- inputs ---------------------------------------------------------------

    def _load(self, dicts) -> _Layout:
        """Pack the host arrays, widest dtype first so every view stays
        aligned, and copy them into the static buffer of their layout:
        one copy, pinned and non-blocking on the card, so a pipelined
        tick does not wait here for the step still in flight."""
        items = sorted(((i, k, np.asarray(a)) for i, d in enumerate(dicts)
                        for k, a in d.items()),
                       key=lambda it: -it[2].dtype.itemsize)
        key = tuple((i, k, a.dtype.str, a.shape) for i, k, a in items)
        lay = self._layouts.get(key)
        if lay is None:
            lay = self._layouts[key] = _Layout(key, self.device)
        flat = torch.from_numpy(np.concatenate(
            [np.ascontiguousarray(a).reshape(-1).view(np.uint8)
             for _, _, a in items]))
        if self.device.type == "cuda":
            flat = flat.pin_memory()
        lay.buf.copy_(flat, non_blocking=True)
        return lay

    def _adopt(self, state) -> None:
        """Make the static state hold ``state`` (``[G]`` lanes): allocated
        from it at the first step, with its row-0 views; after that a copy
        into row 0 of every leaf the node replaced (a leaf that is not
        one of those views), and none of the others."""
        if self.state is None:
            self._static = tree_map(
                lambda t: t.unsqueeze(0).clone(
                    memory_format=torch.contiguous_format), state)
            self.state = tree_map(_row0, self._static)
            return
        for mine, given in zip(_leaves(self.state), _leaves(state)):
            if given is not mine:
                mine.copy_(given)
                self.copied += 1

    # -- the step -------------------------------------------------------------

    def _body(self, lay: _Layout) -> tuple:
        """One ``node_step`` on the static buffers: the next state copied
        into the static state, then what the node reads back packed into
        one tensor (``fetch``), and the row-0 views of the outbox and
        info.  An output that shares memory with an input (the state it
        overwrites, or the inbox the next load overwrites) is cloned
        first, so it keeps this tick's value, as in eager mode."""
        cfg = self.cfg
        new, outbox, info = node_step(
            cfg, self._static, Messages(**lay.views[1]),
            HostInbox(**lay.views[0]))
        mine = _leaves(self._static)
        inputs = {_storage(t) for t in mine} | {_storage(lay.buf)}
        keep = lambda t: t.clone() if _storage(t) in inputs else t
        outbox, info = tree_map(keep, outbox), tree_map(keep, info)
        nxt = [t if t is m else keep(t) for m, t in zip(mine, _leaves(new))]
        for m, t in zip(mine, nxt):
            if t is not m:
                m.copy_(t)
        outbox, info = tree_map(_row0, outbox), tree_map(_row0, info)
        return outbox, info, pack_leaves(self.fetch(self.state, outbox, info))

    def _capture(self, lay: _Layout) -> None:
        graph = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(self.device)
        t0 = time.perf_counter()
        with _CAPTURE_LOCK:
            t1 = time.perf_counter()
            self._stream.wait_stream(cur)
            try:
                with quorum.recording_launches() as rec, \
                        torch.cuda.stream(self._stream):
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        outs = self._body(lay)
                    finally:
                        graph.capture_end()
            except Exception as exc:
                raise RuntimeError(
                    f"capturing node_step as a CUDA graph failed "
                    f"({type(exc).__name__}: {exc}); the step does not "
                    f"run eagerly instead") from exc
            cur.wait_stream(self._stream)
        t2 = time.perf_counter()
        lay.graph, lay.outs, lay.launches = graph, outs, list(rec)
        self.captures += 1
        self.lock_wait_s += t1 - t0
        self.layouts.append((lay.key, t1 - t0, t2 - t1))

    def step(self, state, host_lanes: dict, arrays: dict) -> tuple:
        lay = self._load((host_lanes, arrays))
        self._adopt(state)
        if not self.capture or not self._warm:
            self._warm = True
            return (self.state,) + self._body(lay)
        if lay.graph is None:
            self._capture(lay)
        t0 = time.perf_counter()
        lay.graph.replay()
        self.replay_s += time.perf_counter() - t0
        quorum.count_replay(lay.launches)
        self.replays += 1
        return (self.state,) + lay.outs

    def close(self) -> None:
        """Release every graph with its outputs and input buffer, and the
        static state with its views: called by the node once its tick
        thread has stopped, so the graphs die here and not whenever the
        garbage collector reaches the closed node.  It waits for the card
        to finish what was issued, and for any capture in the process to
        end."""
        with _CAPTURE_LOCK:
            if any(lay.graph is not None for lay in self._layouts.values()):
                torch.cuda.synchronize(self.device)
            self._layouts.clear()
            self._static = self.state = None
