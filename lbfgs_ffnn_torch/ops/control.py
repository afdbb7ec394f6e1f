"""Device-side control flow for captured solver iterations.

The JAX solvers decide inside ``lax.while_loop`` / ``lax.cond``, on the
device. The port's counterpart is a CUDA graph with conditional nodes: a
body runs on the card only when, or for as long as, a device bool says so,
and the host never reads the bool. Three primitives, used by the resident
L-BFGS iteration (:mod:`lbfgs_ffnn_torch.solvers.lbfgs`) and its
device-form line searches (:mod:`lbfgs_ffnn_torch.ops.linesearch`):

* :func:`guard` ``(flag)`` - under :func:`capture`, opens a CUDA graph IF
  node on the device bool ``flag``; the body then runs on each replay only
  when ``flag`` holds. Outside capture (CPU tensors, and the eager
  reference run on the card) the body runs unconditionally.
* :func:`assign` ``(flag, dst, new)`` - a guarded body's only way to change
  state: under capture ``dst.copy_(new)`` (the IF node already guarantees
  ``flag``), outside it ``dst.copy_(torch.where(flag, new, dst))``.
* :func:`loop` ``(cond_fn, body)`` - ``while cond_fn(): body()``. Under
  capture one CUDA graph WHILE node holds one copy of the body: a
  set-conditional kernel before the node and another as the body's last
  node read the device bool ``cond_fn()`` returns. Outside capture the
  host reads that bool once per pass (and once at the end): the same body
  and the same writes, so a captured loop equals its eager run bitwise,
  at one host sync per pass where a masked run of the whole budget would
  pay the budget in compute (the Wolfe search's budget of 100 trials
  every iteration, where a search takes a few). :func:`host_reads` counts those
  syncs. The body runs only while the bool holds, in both modes, so it
  writes its state with plain in-place copies; state it carries from one
  pass to the next lives in tensors made before the loop.

So a guarded body leaves the state unchanged when its flag is false, in both
modes, and no value reaches the host but a loop's flag outside capture: the
CPU tests run the same code, counters and all, as the captured graph.

torch 2.11's ``torch.cuda.CUDAGraph`` has no method that opens a
conditional node, so ``csrc/conditional.cu`` (built by
:mod:`lbfgs_ffnn_torch._build`, loaded with ctypes) adds the node to the
graph torch is capturing and captures the body on a stream of its own, one
per nesting depth; the body's allocations go to a memory pool of the
:class:`Graph`, one per depth, routed there by stream while the body is
captured. Conditional nodes need CUDA 12.4 or later in the driver and the
toolkit. There is no other route: where the node cannot be made, capture
raises and says why.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Callable

import torch

_TORCH_POOL_CALLS = ("_cuda_beginAllocateCurrentStreamToPool", "_cuda_endAllocateToPool",
                     "_cuda_releasePool")


def capturing(t: torch.Tensor) -> bool:
    """Whether work on ``t``'s device is being captured into a CUDA graph
    on the current stream (always false for a CPU tensor)."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


def conditional_nodes_supported() -> tuple[bool, str]:
    """(supported, reason): whether this torch lets a body's allocations be
    routed to a graph's memory pool, which :func:`guard` needs beside
    ``csrc/conditional.cu``."""
    missing = [name for name in _TORCH_POOL_CALLS if not hasattr(torch._C, name)]
    if missing:
        return False, f"torch {torch.__version__} lacks torch._C.{', '.join(missing)}"
    return True, ""


def _lib() -> ctypes.CDLL:
    from lbfgs_ffnn_torch import _build

    lib = _build.load("conditional")
    if not getattr(lib, "_argtypes_set", False):
        p = ctypes.c_void_p
        lib.cond_stream_create.argtypes = [ctypes.POINTER(p)]
        lib.cond_begin_if.argtypes = [p, p, p]
        lib.cond_begin_while.argtypes = [p, p, p, ctypes.POINTER(ctypes.c_ulonglong)]
        lib.cond_set.argtypes = [p, ctypes.c_ulonglong, p]
        lib.cond_end.argtypes = [p]
        lib.cond_invalidate.argtypes = [p]
        lib.cond_error_string.argtypes = [ctypes.c_int]
        lib.cond_error_string.restype = ctypes.c_char_p
        for fn in (lib.cond_stream_create, lib.cond_begin_if, lib.cond_begin_while, lib.cond_set,
                   lib.cond_end, lib.cond_invalidate):
            fn.restype = ctypes.c_int
        lib._argtypes_set = True
    return lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc} "
                           f"({_lib().cond_error_string(rc).decode()}); the resident solve "
                           "needs CUDA graph conditional nodes (CUDA 12.4+ driver and toolkit)")


_BODY_STREAMS: dict[tuple[int, int], torch.cuda.ExternalStream] = {}


def _body_stream(device: torch.device, depth: int) -> torch.cuda.ExternalStream:
    key = (device.index, depth)
    if key not in _BODY_STREAMS:
        ptr = ctypes.c_void_p()
        with torch.cuda.device(device):
            _check(_lib().cond_stream_create(ctypes.byref(ptr)), "cond_stream_create")
        _BODY_STREAMS[key] = torch.cuda.ExternalStream(ptr.value, device=device)
    return _BODY_STREAMS[key]


class Graph:
    """A CUDA graph captured through :func:`capture`, and the memory pools
    its guarded bodies allocate from (released when it goes)."""

    def __init__(self, flat: bool = False):
        self.cuda_graph = torch.cuda.CUDAGraph()
        self.flat = flat  # every guard's body inline, no IF node
        self.depth = 0
        self._device: torch.device | None = None
        self._pools: dict[int, tuple] = {}  # depth -> pool id
        self._refs: dict[int, int] = {}     # depth -> begins to release

    def replay(self) -> None:
        self.cuda_graph.replay()

    def _pool(self, device: torch.device, depth: int) -> tuple:
        self._device = device
        if depth not in self._pools:
            self._pools[depth] = torch.cuda.graph_pool_handle()
        self._refs[depth] = self._refs.get(depth, 0) + 1
        return self._pools[depth]

    def __del__(self):
        self.cuda_graph = None
        if getattr(torch, "_C", None) is None:  # the interpreter is shutting down
            return
        for depth, pool in self._pools.items():
            for _ in range(self._refs[depth]):
                torch._C._cuda_releasePool(self._device.index, pool)


_CAPTURE: Graph | None = None


@contextlib.contextmanager
def capture(graph: Graph):
    """``torch.cuda.graph`` for a :class:`Graph` whose capture may open
    guards and loops; the default capture mode ("global") raises on any
    host sync. A ``Graph(flat=True)`` captures every guard's body inline,
    without an IF node, and every loop's body once: a check that a body can
    be captured at all, never replayed. (A host sync inside a conditional
    node's body cannot be unwound cleanly: the body
    graph's capture is invalidated, and ending the enclosing capture then
    crashed the process on the card; a flat capture raises as a plain one
    does.)"""
    global _CAPTURE
    if _CAPTURE is not None:
        raise RuntimeError("one capture at a time")
    stream = torch.cuda.current_stream()
    try:
        with torch.cuda.graph(graph.cuda_graph):
            _CAPTURE = graph
            try:
                yield graph
            finally:
                _CAPTURE = None
    finally:
        # where ending the capture raises (a failed body invalidated it),
        # torch's context leaves its capture stream current
        torch.cuda.set_stream(stream)


def _flag(flag: torch.Tensor, who: str) -> None:
    if flag.dtype != torch.bool or flag.numel() != 1:
        raise ValueError(f"{who} takes a one-element bool tensor, got {flag.dtype} "
                         f"{tuple(flag.shape)}")


@contextlib.contextmanager
def _node(graph: Graph, flag: torch.Tensor, begin):
    """Open a conditional node on ``flag`` with ``begin(parent, flag, body)``
    (a ``cond_begin_*`` call) and capture the ``with`` block into its body
    graph, on the body stream of the next depth, its allocations routed to
    that depth's pool; yields the body stream."""
    ok, why = conditional_nodes_supported()
    if not ok:
        raise RuntimeError(f"cannot capture a conditional node: {why}")
    dev = flag.device
    depth = graph.depth + 1
    body = _body_stream(dev, depth)
    pool = graph._pool(dev, depth)
    parent = torch.cuda.current_stream(dev).cuda_stream
    begin(parent, flag.contiguous().data_ptr(), body.cuda_stream)
    graph.depth = depth
    try:
        with torch.cuda.stream(body):
            torch._C._cuda_beginAllocateCurrentStreamToPool(dev.index, pool)
            try:
                yield body
            finally:
                torch._C._cuda_endAllocateToPool(dev.index, pool)
    except BaseException:
        # A body that failed leaves its graph half built: its capture ends
        # here, each enclosing body's as the exception passes, and the
        # outermost capture is invalidated, so that it raises at its end and
        # no graph holding the broken body is instantiated. Invalidating a
        # body's capture inside another node's body instead crashed the
        # process when the outermost capture ended (on an H100, CUDA 13.0
        # driver); a host sync in a nested body may still do that, which is
        # why a flat capture comes first (see capture).
        graph.depth = depth - 1
        _lib().cond_end(body.cuda_stream)
        if depth == 1:
            _lib().cond_invalidate(parent)
        raise
    graph.depth = depth - 1
    _check(_lib().cond_end(body.cuda_stream), "cond_end")


def _open_capture(who: str) -> Graph:
    graph = _CAPTURE
    if graph is None:
        raise RuntimeError(f"a {who} under capture needs lbfgs_ffnn_torch.ops.control.capture")
    return graph


@contextlib.contextmanager
def guard(flag: torch.Tensor):
    """Run the body only where the device bool ``flag`` is true: an IF node
    under :func:`capture`, unconditionally (with :func:`assign` masking the
    writes) outside it."""
    _flag(flag, "guard")
    if not capturing(flag):
        yield
        return
    graph = _open_capture("guard")
    if graph.flat:
        yield
        return

    def begin(parent, flag_ptr, body):
        _check(_lib().cond_begin_if(parent, flag_ptr, body), "cond_begin_if")

    with _node(graph, flag, begin):
        yield


_HOST_READS = [0]  # flags read by loops run outside capture, in this process


def host_reads() -> int:
    """How many times, in this process so far, a :func:`loop` outside
    capture read its flag on the host (each read a host sync on the card);
    a caller counts its own as a difference."""
    return _HOST_READS[0]


def _read(flag: torch.Tensor) -> bool:
    _HOST_READS[0] += 1
    return bool(flag)


def loop(cond_fn: Callable[[], torch.Tensor], body: Callable[[], None]) -> None:
    """``while cond_fn(): body()`` with ``cond_fn()`` a one-element device
    bool: a CUDA graph WHILE node under :func:`capture` (the bool computed
    before the node and again as the body's last step, each read by a
    set-conditional kernel), a host loop that reads the bool once per pass
    outside it. A flat capture runs the body once inline. Inside a
    :func:`guard`, put the guard's flag in ``cond_fn``: outside capture a
    guard's body runs whatever its flag, and a loop's writes are not
    masked."""
    flag = cond_fn()
    _flag(flag, "loop")
    if not capturing(flag):
        while _read(flag):
            body()
            flag = cond_fn()
        return
    graph = _open_capture("loop")
    if graph.flat:
        body()
        cond_fn()
        return
    handle = ctypes.c_ulonglong()

    def begin(parent, flag_ptr, body_stream):
        _check(_lib().cond_begin_while(parent, flag_ptr, body_stream, ctypes.byref(handle)),
               "cond_begin_while")

    with _node(graph, flag, begin) as body_stream:
        body()
        again = cond_fn()
        _flag(again, "loop")
        _check(_lib().cond_set(body_stream.cuda_stream, handle.value,
                               again.contiguous().data_ptr()), "cond_set")


def assign(flag: torch.Tensor, dst: torch.Tensor, new) -> None:
    """``dst <- new`` where ``flag`` holds, in place; ``dst`` unchanged
    otherwise. Under capture this is a plain copy: call it only inside
    :func:`guard` ``(flag)``."""
    if capturing(dst):
        dst.copy_(new)
    else:
        dst.copy_(torch.where(flag, new, dst))
