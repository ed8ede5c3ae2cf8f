"""The decode step as one captured CUDA graph: the port's counterpart of
the reference's jitted decode step (``_decode_paged_jit`` / ``_decode_jit``
in its engine), which runs the whole step as one compiled executable.

* ``StaticInputs`` — a step's inputs as typed views of ONE device byte
  buffer, written each step by one copy from a pinned host mirror whose
  numpy views the engine fills. Their addresses never move, so a captured
  graph reads each step's values.
* ``DecodeGraph`` — a step function over those views and the state it
  updates in place (``state``: the KV pools or rows, and the Mamba
  layers' ``conv``/``state`` rows; a replay advances them with no copy,
  the same graph for every backend). On the card it is
  captured once (after a warm-up on a side stream, as
  ``torch.cuda.graph`` requires) and replayed on the current stream; on the
  CPU, and on the card inside ``eager()``, the same function runs op by op.
  The engine keeps two over one set of inputs and one memory pool: the
  step on the served banks and the batch tier's step on the all-lo view
  (``serving.lobanks``). With ``graphed=False`` (an engine under a
  distribution context, whose step calls collectives no CUDA graph can
  capture) it always runs op by op.

A replay calls no kernel wrapper, so the launch counts each wrapper added
during capture (``kernels.ops.LAUNCHES``) are added again on every replay;
the warm-up and the capture themselves count nothing. A served run thus
reports the same launches under the graph as eagerly.

Capture needs every op of the step to stay on the device: no host read
(``.item()``, ``torch.bincount``, ``torch.nonzero``, a bool-mask index), no
host→device copy of fresh data (``torch.tensor``), and nothing the graph
reads (parameters, caches, expert banks, these buffers) reallocated after
it. The warm-up runs with CUDA's sync debug mode set to raise, so a host
read fails there with the op's traceback. A step that cannot be captured
raises; it never falls back to running eagerly.
"""
from __future__ import annotations

import contextlib
import gc
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ops as kops

_EAGER = False


@contextlib.contextmanager
def eager():
    """Decode op by op on the card while the context is open (the
    counterpart of ``jax.disable_jit``): for holding the graph against the
    ops it captured. Outside it, an engine on the card always decodes
    through its graph."""
    global _EAGER
    prev, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = prev


class StaticInputs:
    """Typed views ``dev[name]`` of one device byte buffer and their host
    mirrors ``host[name]`` (numpy views of one pinned buffer), from
    ``fields`` = [(name, shape, dtype)]; each field starts 8-byte aligned.
    On the CPU the two are the same memory."""

    def __init__(self, fields: Sequence[Tuple[str, tuple, torch.dtype]],
                 device: torch.device):
        spans, size = [], 0
        for name, shape, dtype in fields:
            size = -(-size // 8) * 8
            n = torch.Size(shape).numel() * dtype.itemsize
            spans.append((name, shape, dtype, size, n))
            size += n
        cuda = device.type == "cuda"
        self.host_buf = torch.zeros(size, dtype=torch.uint8, pin_memory=cuda)
        self.dev_buf = torch.zeros(size, dtype=torch.uint8, device=device) \
            if cuda else self.host_buf
        self.host, self.dev = {}, {}
        for name, shape, dtype, off, n in spans:
            self.host[name] = self.host_buf[off:off + n].view(dtype) \
                .view(shape).numpy()
            self.dev[name] = self.dev_buf[off:off + n].view(dtype).view(shape)

    def push(self) -> None:
        """The one host→device copy of a step (asynchronous from pinned
        memory, on the current stream). The host mirror must not be
        written again before the step that reads it has been synchronised
        with."""
        if self.dev_buf is not self.host_buf:
            self.dev_buf.copy_(self.host_buf, non_blocking=True)


class DecodeGraph:
    """``fn()`` (a tuple of tensors, computed from ``inputs.dev`` and
    state that stays in place) run as one CUDA graph on the card."""

    #: Eager runs on the side stream before capture (lazy initialisation of
    #: kernel libraries, launch plans and cuBLAS happens there).
    WARMUP = 3

    def __init__(self, fn: Callable[[], tuple], inputs: StaticInputs,
                 device: torch.device, pool=None,
                 state: Sequence[torch.Tensor] = (), graphed: bool = True):
        """``pool``: a ``torch.cuda.graph_pool_handle()`` shared with other
        graphs over the same inputs. Graphs that share a pool must run one
        after the other on one stream, and each one's outputs are read
        before another replays (a later capture may place its outputs in
        memory an earlier graph uses for its temporaries). ``state``: the
        tensors ``fn`` updates in place; a replay raises if one of them
        has been reallocated since the capture. ``graphed=False``: never
        captured, ``fn`` runs op by op on the card too."""
        self.fn = fn
        self.graphed = graphed
        self.inputs = inputs
        self.device = device
        self.pool = pool
        self.state = list(state)
        self._state_ptrs: List[int] = []
        self.graph = None
        self.outputs: tuple = ()
        self.launches: Dict[str, int] = {}   # kernel → launches per replay
        # Set to [] to time every replay: (start, end) CUDA events around
        # the replay alone (device time, read after a synchronise).
        self.events: Optional[List[tuple]] = None

    @property
    def needs_capture(self) -> bool:
        return self.graphed and self.device.type == "cuda" and \
            not _EAGER and self.graph is None

    def capture(self) -> None:
        """Warm up and capture ``fn`` over the inputs as they are now. The
        caller fills them so that running the step changes no state it
        keeps (every row vacant)."""
        self.inputs.push()
        saved = dict(kops.LAUNCHES)
        try:
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            debug = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with torch.cuda.stream(side):
                    for _ in range(self.WARMUP):
                        self.fn()
            finally:
                torch.cuda.set_sync_debug_mode(debug)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            start = dict(kops.LAUNCHES)
            # No collection inside the capture: freeing an unreachable
            # engine's graph there (cudaGraphExecDestroy) is not permitted
            # while a stream captures, and invalidates this capture.
            collect = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool):
                    outputs = self.fn()
            finally:
                if collect:
                    gc.enable()
            self.launches = {k: n - start[k] for k, n in kops.LAUNCHES.items()
                             if n != start[k]}
            torch.cuda.synchronize(self.device)
        except Exception as e:
            raise RuntimeError(f"the decode step could not be captured as a "
                               f"CUDA graph: {e}") from e
        finally:
            kops.LAUNCHES.update(saved)
        self.graph, self.outputs = graph, outputs
        self._state_ptrs = [t.data_ptr() for t in self.state]

    def run(self) -> tuple:
        """One step: push the inputs, then replay (or run ``fn`` op by op
        on the CPU and inside ``eager()``)."""
        self.inputs.push()
        if self.device.type != "cuda" or _EAGER or not self.graphed:
            return self.fn()
        if self.graph is None:
            raise RuntimeError("the decode step has not been captured yet "
                               "(capture() first)")
        if any(t.data_ptr() != p for t, p in zip(self.state,
                                                 self._state_ptrs)):
            raise RuntimeError("state the decode graph updates in place was "
                               "reallocated after its capture")
        if self.events is None:
            self.graph.replay()
        else:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.graph.replay()
            end.record()
            self.events.append((start, end))
        for k, n in self.launches.items():
            kops.LAUNCHES[k] += n
        return self.outputs
