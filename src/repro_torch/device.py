"""Where the port's entry points run (the card unless the caller asks for
the CPU), the constants a step keeps on its device, the CUDA streams its
serving threads and graph captures borrow, and the CUDA graph capture
that the Spikformer step (``infer/compile.py:GraphedStep``), the LM
engine (``launch/serve.py:Engine``) and the training steps share, with
the training step over state it owns (``TrainStep``: the Spikformer's,
``core/spikformer.py``, and the LM's, ``launch/steps.py``)."""
from __future__ import annotations

import contextlib
import gc
import threading
import traceback
import weakref

import torch

from .nn.module import copy_tree, map_with_path, tree_paths


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without one, fail and name the CPU
    option."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain versions of the kernels on the "
                           "CPU")
    return device


_CONSTANTS: dict = {}
_CONSTANTS_LOCK = threading.RLock()


def constant(key, device, make) -> torch.Tensor:
    """The tensor ``make(device)``, made once per ``key`` and device and
    kept: a step's constants (a threshold, a lookup table) reach the card
    without a host-to-device copy each call, which would also stop a CUDA
    graph capture. It must first be made outside a capture: a tensor made
    while a graph records holds its values only once the graph replays.
    Serving threads share the table, so it is filled under a lock: two
    threads never make one constant twice."""
    device = torch.device(device)
    found = _CONSTANTS.get((key, device))
    if found is None:
        with _CONSTANTS_LOCK:
            found = _CONSTANTS.get((key, device))
            if found is None:
                if (device.type == "cuda"
                        and torch.cuda.is_current_stream_capturing()):
                    raise RuntimeError(
                        f"constant {key!r} was first needed inside a CUDA "
                        "graph capture; run the step once eagerly before "
                        "capturing it")
                found = _CONSTANTS[(key, device)] = make(device)
    return found


_SPARE_STREAMS: dict = {}
_STREAMS_LOCK = threading.Lock()


def borrow_stream(device) -> torch.cuda.Stream:
    """A CUDA stream of ``device`` that no other holder has: a released
    one when there is one, else a new one. Streams are reused, not made
    anew for each holder, because cuBLAS keeps a workspace (32 MiB on an
    H100) for every stream it has run on for the life of the process: a
    fleet that swaps plans would otherwise grow by one workspace per
    replica and swap. Exclusive, because a graph captured on a stream
    keeps that stream's workspace: two graphs replaying at once must not
    share one."""
    device = torch.device(device)
    with _STREAMS_LOCK:
        spare = _SPARE_STREAMS.setdefault(device, [])
        return spare.pop() if spare else torch.cuda.Stream(device)


def release_stream(stream: torch.cuda.Stream) -> None:
    """Give a borrowed stream back (its holder will not use it again)."""
    with _STREAMS_LOCK:
        _SPARE_STREAMS.setdefault(stream.device, []).append(stream)


@contextlib.contextmanager
def borrowed_stream(device):
    """Run the block on a borrowed stream of ``device``, released after."""
    stream = borrow_stream(device)
    try:
        with torch.cuda.stream(stream):
            yield stream
    finally:
        release_stream(stream)


# ---------------------------------------------------------------------------
# CUDA graph capture
# ---------------------------------------------------------------------------

# one capture at a time in the process: a capture's eager warm-up and its
# recording must not interleave with another thread's
_CAPTURE_LOCK = threading.Lock()


def _failed_at(err: BaseException) -> str:
    """The innermost frame of ``err``'s traceback outside torch: the op
    that stopped a capture."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if "/torch/" not in f.filename]
    if not frames:
        return "an unknown op"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} in {f.name}: {f.line}"


class GraphCapturer:
    """Captures one owner's CUDA graphs (a ``GraphedStep``'s buckets, an LM
    engine's steps, a training step): on a side stream the owner holds
    alone while it lives (``borrow_stream``, at the first capture: a
    cuBLAS call captured on a stream keeps that stream's workspace, which
    two owners replaying at once must not share), into one graph memory
    pool its graphs share."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = None
        self.pool = None

    def __call__(self, body, what: str):
        """Record ``body()`` as a CUDA graph; returns ``(graph, out,
        launches)``: ``body``'s result (which each replay rewrites in
        place) and the port's kernel launches the capture recorded, by
        name.

        ``body`` first runs once eagerly on the side stream, so kernels are
        built, their attributes set and a step's constants made before
        anything records. The card is synchronised first (a borrowed
        stream's last holder may have left a replay in flight that uses the
        stream's cuBLAS workspace). Captures take a process-wide lock and
        record with ``capture_error_mode="thread_local"`` (under the default
        "global" mode a read-back or an allocation on another serving thread
        would invalidate the capture), and count the capturing thread's
        launches only (``ops.recording_launches``). A capture that fails
        raises and names the op (``_failed_at``); nothing then runs eagerly
        in its place. A failed capture's pool is left behind: torch keeps
        it marked as recording, so the next capture starts a new one.
        Python's cyclic collector is held off during the capture
        (``_collector_held_off``)."""
        from .kernels import ops
        if self.stream is None:
            self.stream = borrow_stream(self.device)
            weakref.finalize(self, release_stream, self.stream)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        stream, dev = self.stream, self.stream.device
        with _CAPTURE_LOCK:
            torch.cuda.synchronize(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                body()
            torch.cuda.current_stream(dev).wait_stream(stream)
            graph = torch.cuda.CUDAGraph()
            failure, out = None, None
            # the outer stream context restores the caller's stream even
            # when the capture's own exit raises before restoring it
            with _collector_held_off(), \
                    ops.recording_launches() as recorded, \
                    torch.cuda.stream(stream):
                try:
                    with torch.cuda.graph(graph, pool=self.pool,
                                          stream=stream,
                                          capture_error_mode="thread_local"):
                        try:
                            out = body()
                        except Exception as e:  # noqa: BLE001  (raised below)
                            failure = e
                except Exception as e:  # noqa: BLE001  an invalid capture
                    failure = failure or e
                    _stop_allocating_to(self.pool, dev)
                    self.pool = None
        if failure is not None:
            raise RuntimeError(f"CUDA graph capture of {what} failed at "
                               f"{_failed_at(failure)}: {failure}") from failure
        return graph, out, dict(recorded)


@contextlib.contextmanager
def _collector_held_off():
    """Holds Python's cyclic collector off for the block. A CUDA graph
    destroyed while this thread captures another invalidates that capture
    (its destructor's calls are refused during a capture), and a dead graph
    can wait in a reference cycle for the collector, to be destroyed
    whenever it next runs: a failed capture's graph is held by its
    exception's traceback, an engine's graphs by any cycle through the
    engine. Outside a capture the collector destroys them harmlessly."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def _stop_allocating_to(pool, device: torch.device) -> None:
    """After a capture the card invalidated (a host read in the body, for
    one): torch's capture end raises before it stops sending the capturing
    stream's allocations to ``pool``; stop it, unless the capture never got
    that far."""
    try:
        torch._C._cuda_endAllocateToPool(device.index, pool)
    except RuntimeError:            # not recording to the pool
        pass


class StepGraph:
    """One captured step: the graph, its static input (a tensor, or a
    tuple of them: a training step's images and labels) and output, a
    pinned staging buffer for each host input, the kernel launches its
    capture recorded (each replay launches them again) and its replays
    since the last reset."""

    def __init__(self, graph, static_in, out, launches):
        self.graph = graph
        self.static_in = static_in
        self.out = out
        self.launches = launches
        self._staged = [(t, torch.empty(t.shape, dtype=t.dtype,
                                        pin_memory=True))
                        for t in _as_tuple(static_in)]
        self.copied = torch.cuda.Event()
        self.replays = 0

    def load(self, x) -> None:
        """Copy an input (a tuple, where the static input is one) into the
        static input: from the card in place, from the host through the
        pinned buffers without a host wait (only the previous copy out of
        those buffers must be done before they are refilled)."""
        xs = _as_tuple(x)
        if len(xs) != len(self._staged):
            raise ValueError(f"{len(xs)} inputs for a step that takes "
                             f"{len(self._staged)}")
        if all(t.device.type == "cuda" for t in xs):
            for (static, _), t in zip(self._staged, xs):
                static.copy_(t)
            return
        self.copied.synchronize()
        for (static, host), t in zip(self._staged, xs):
            if t.device.type == "cuda":
                static.copy_(t)
            else:
                host.copy_(t)
                static.copy_(host, non_blocking=True)
        self.copied.record()

    def replay(self, x):
        """Load ``x``, replay on the current stream; returns the static
        output, which the next replay overwrites."""
        self.load(x)
        self.graph.replay()
        self.replays += 1
        return self.out


def _as_tuple(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def graph_launch_counts(graphs) -> dict:
    """Kernel launches that the replays of ``graphs`` (``StepGraph``s) made
    since their last reset: captured launches times replays."""
    counts: dict = {}
    for g in graphs:
        for name, n in g.launches.items():
            counts[name] = counts.get(name, 0) + n * g.replays
    return counts


# ---------------------------------------------------------------------------
# a training step over state it owns
# ---------------------------------------------------------------------------

def _signature(tree) -> list:
    """Each leaf's path, shape and dtype."""
    return [(p, tuple(t.shape), t.dtype) for p, t in tree_paths(tree)]


class TrainStep:
    """A functional training step ``fn(params, opt, batch) -> (params,
    opt, metrics)`` as the reference jits it (``jax.jit(...,
    donate_argnums=(0, 1))``): over params and optimizer state that the
    step owns, in tensors that never move. Each step writes its new values
    into them in place; ``fn`` computes every new leaf before the first
    one is written. The metrics (``metrics``, names of ``fn``'s scalar
    outputs) come back as static 0-d f32 tensors that the next step
    rewrites: read them before it.

    ``step(params, opt, batch) -> (params, opt, metrics)`` is the
    reference's calling convention. The first call takes ``params`` and
    ``opt`` as the step's own (donated: the caller uses them again only
    through what the step returns); a call with the trees the step
    returned runs on them as they are; a call with other trees of the
    same leaves (a restored checkpoint) copies them in first. ``own``
    hands the step its state up front, ``run(batch)`` steps it and
    returns the metrics, ``state()`` returns a copy of it.

    ``graphed`` (the card): the first step captures the whole step as one
    CUDA graph through a ``GraphCapturer`` (``what`` names it; a capture
    that fails raises and names the op, and nothing runs eagerly in its
    place). The capture's warm-up runs the body once eagerly on the real
    state and batch: that run is the first step, and its metrics are that
    call's result; every later step replays. Else the same body runs
    eagerly.

    The batch is a dict of ``batch_keys`` (tensors on the host or the
    device, or arrays); the keys, shapes and dtypes of the first are
    fixed, and a batch of other ones raises. The graph reads it from
    static tensors in ``batch_keys`` order (contiguous copies, an expanded
    view's too), loaded in place each step (``StepGraph.load``).

    ``shardings`` (a mesh): ``(params, opt, batch, metric)``
    ``sharding.rules.NamedSharding``s (trees for the first three, one for
    every metric). The owned state is placed once by them, and each batch
    is placed into DTensors before it is loaded, outside the graph."""

    def __init__(self, fn, metrics, batch_keys, *, device, graphed: bool,
                 what: str, shardings=None):
        self.fn, self.metric_names = fn, tuple(metrics)
        self.batch_keys = tuple(batch_keys)
        self.device, self.graphed, self.what = device, graphed, what
        self.shardings = shardings
        self.params = self.opt = self.metrics = None
        self.batch_spec = None          # [(key, shape, dtype)] of the batch
        self.graph = None               # a StepGraph once captured
        self._capture = GraphCapturer(device) if graphed else None

    def __call__(self, params, opt, batch: dict) -> tuple:
        if self.params is None:
            self.own(params, opt)
        elif params is not self.params or opt is not self.opt:
            self._take(params, opt)
        self.run(batch)
        return self.params, self.opt, self.metrics

    def own(self, params, opt) -> None:
        """``params`` and ``opt`` become the step's state (placed by the
        shardings on a mesh)."""
        params, opt = self._placed(params, opt)
        metrics = {k: torch.zeros((), dtype=torch.float32,
                                  device=self.device)
                   for k in self.metric_names}
        if self.shardings is not None:
            from .sharding import rules
            metrics = {k: rules.place(v, self.shardings[3])
                       for k, v in metrics.items()}
        self.params, self.opt, self.metrics = params, opt, metrics

    def run(self, batch: dict) -> dict:
        """One step on the owned state; returns the static metrics."""
        batch = self._batch(batch)
        if not self.graphed:
            return self.body(batch)
        if self.graph is None:
            static = {k: t.to(self.device).clone(
                memory_format=torch.contiguous_format)
                for k, t in batch.items()}
            graph, out, launches = self._capture(lambda: self.body(static),
                                                 self.what)
            self.graph = StepGraph(graph, tuple(static.values()), out,
                                   launches)
            return self.metrics
        return self.graph.replay(tuple(batch.values()))

    def body(self, batch: dict) -> dict:
        """One step in place on the owned state, ``batch`` on the device.
        Returns the static metric tensors. No host read and no
        host-to-device copy: a CUDA graph records it."""
        params, opt, metrics = self.fn(self.params, self.opt, batch)
        copy_tree(self.params, params)
        copy_tree(self.opt, opt)
        for k in self.metric_names:
            self.metrics[k].copy_(metrics[k])
        return self.metrics

    def state(self) -> tuple:
        """``(params, opt)``: a copy of the current state."""
        def copy(_, t):
            return t.detach().clone()
        return map_with_path(copy, self.params), map_with_path(copy,
                                                               self.opt)

    def _batch(self, batch: dict) -> dict:
        """The batch's tensors by ``batch_keys``, checked against the first
        batch's; placed by the batch shardings on a mesh."""
        other = sorted(set(batch) - set(self.batch_keys))
        if other:
            raise ValueError(f"the train step takes no batch key {other}")
        batch = {k: torch.as_tensor(batch[k]) for k in self.batch_keys
                 if k in batch}
        spec = [(k, tuple(t.shape), t.dtype) for k, t in batch.items()]
        if self.batch_spec is None:
            self.batch_spec = spec
        elif spec != self.batch_spec:
            raise ValueError(f"the train step was built for a batch of "
                             f"{self.batch_spec}, not {spec}")
        if self.shardings is not None:
            from .sharding import rules
            return {k: rules.place(t.to(self.device), self.shardings[2][k])
                    for k, t in batch.items()}
        if self.graphed:        # a replay loads host values itself
            return batch
        return {k: t.to(self.device) for k, t in batch.items()}

    def _placed(self, params, opt) -> tuple:
        if self.shardings is None:
            return params, opt
        from .sharding import rules
        return (rules.place_tree(params, self.shardings[0]),
                rules.place_tree(opt, self.shardings[1]))

    def _take(self, params, opt) -> None:
        """Other trees of the same leaves copied into the step's own."""
        params, opt = self._placed(params, opt)
        for mine, theirs in ((self.params, params), (self.opt, opt)):
            if _signature(theirs) != _signature(mine):
                raise ValueError("the train step's state has other leaves, "
                                 "shapes or dtypes than the trees passed in")
            copy_tree(mine, theirs)
