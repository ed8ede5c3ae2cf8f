"""The decode step as one captured CUDA graph: the port's counterpart of
the reference's jitted decode step (``_decode_paged_jit`` / ``_decode_jit``
in its engine), which runs the whole step as one compiled executable.

* ``StaticInputs`` — a step's inputs as typed views of ONE device byte
  buffer, written each step by one copy from a pinned host mirror whose
  numpy views the engine fills. Their addresses never move, so a captured
  graph reads each step's values.
* ``DecodeGraph`` — a step function over those views. On the card it is
  captured once (after a warm-up on a side stream, as
  ``torch.cuda.graph`` requires) and replayed on the current stream; on the
  CPU, and on the card inside ``eager()``, the same function runs op by op.

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
                 device: torch.device):
        self.fn = fn
        self.inputs = inputs
        self.device = device
        self.graph = None
        self.outputs: tuple = ()
        self.launches: Dict[str, int] = {}   # kernel → launches per replay
        # Set to [] to time every replay: (start, end) CUDA events around
        # the replay alone (device time, read after a synchronise).
        self.events: Optional[List[tuple]] = None

    @property
    def needs_capture(self) -> bool:
        return self.device.type == "cuda" and not _EAGER and \
            self.graph is None

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
            with torch.cuda.graph(graph):
                outputs = self.fn()
            self.launches = {k: n - start[k] for k, n in kops.LAUNCHES.items()
                             if n != start[k]}
            torch.cuda.synchronize(self.device)
        except Exception as e:
            raise RuntimeError(f"the decode step could not be captured as a "
                               f"CUDA graph: {e}") from e
        finally:
            kops.LAUNCHES.update(saved)
        self.graph, self.outputs = graph, outputs

    def run(self) -> tuple:
        """One step: push the inputs, then replay (or run ``fn`` op by op
        on the CPU and inside ``eager()``)."""
        self.inputs.push()
        if self.device.type != "cuda" or _EAGER:
            return self.fn()
        if self.graph is None:
            raise RuntimeError("the decode step has not been captured yet "
                               "(capture() first)")
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
