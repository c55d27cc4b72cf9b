"""The eager stretches of a bounce iteration, captured once as CUDA graphs
and replayed between the traversal kernels.

A *stretch* is the eager PyTorch between two traversal-kernel calls: a
few hundred to a few thousand elementwise launches an iteration, which the
host enqueues at 13-16 us each while the card idles.  The integrator and
the wavefront write such code as generator functions: the code between two
``yield``s is a stretch, and each ``yield`` hands ``run`` a request:

  - ``Call(module, name, *args)``: a traversal wrapper's call, looked up on
    its module at every call (so a wrapper set on the attribute sees every
    call); its result is sent back into the generator;
  - ``Enter(name)`` and ``EXIT``: open and close a ``profiling.span``
    around the stretches and calls between them.

``run(fn, consts, inputs)`` drives ``fn(*consts, *inputs)`` one of two ways,
decided from the inputs alone:

  - eagerly, request by request, exactly as plain code would run: where an
    input is not a tensor (a Python number would be baked into a graph), a
    tensor is not on a CUDA device, or something requires grad;
  - by graphs, everywhere else: the first call with a key runs ``fn`` once
    eagerly (the warm-up: lazy module loads happen outside a capture), then
    captures each stretch as one graph on a pool of its own, replaying each
    right after its capture so that the requests between them see real
    values; every later call copies its inputs into the graphs' input
    buffers, replays the stretches in order and makes each request between
    them eagerly, with the arguments it had at capture, copying its result
    into the buffers the next stretch reads.

The key is ``fn``, the identity of each const (the entry holds them, so an
id is never reused while it is a key) and, for each input, its shape,
dtype and device.  An input that is an output of a graph of another
function (the wavefront's carry, written in place by its graphs) is read
where it lies, and its address joins the key; every other input is copied
into a buffer of the entry.  So a loop whose graphs feed each other copies
nothing between them.  ``into``: tensors that a graph run overwrites with
its outputs at its end (in the graph, after every read); an eager run
returns its outputs instead, which the caller takes as the same values.

A graph run returns the entry's buffers: the next run of the same entry
overwrites them.  The entries are kept in a process-wide cache of at most
``MAX_ENTRIES`` keys, least recently used first out, as PyTorch keeps its
own plan caches: a key holds the scene and the buffers it reads, so two
callers share an entry only where they pass the same ones.  The counts
``step_graph_replays``, ``step_graph_captures`` and ``step_graph_eager``
(``profiling.count``, while a record is on) add the stretches each run
replayed, captured or ran eagerly.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

from paths_tpu_torch import profiling as P

MAX_ENTRIES = 12


class Call:
    """A traversal wrapper's call between two stretches."""

    __slots__ = ("module", "name", "args")

    def __init__(self, module, name: str, *args):
        self.module, self.name, self.args = module, name, args

    def __call__(self):
        return getattr(self.module, self.name)(*self.args)


class Enter:
    """Opens the span `name` until the next ``EXIT``."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name


EXIT = object()


def single(fn):
    """A plain function as a generator function of one stretch."""
    def gen(*args):
        return fn(*args)
        yield  # makes gen a generator function
    gen.__name__ = gen.__qualname__ = fn.__name__
    return gen


class _Spans:
    """The spans the requests opened, closed in order or on an error."""

    def __init__(self):
        self.open = []

    def request(self, req):
        if isinstance(req, Enter):
            sp = P.span(req.name)
            sp.__enter__()
            self.open.append(sp)
        elif req is EXIT:
            self.open.pop().__exit__(None, None, None)
        else:
            return req()
        return None

    def close(self):
        while self.open:
            self.open.pop().__exit__(None, None, None)


def _drive(gen):
    """Drives a generator of stretches eagerly: (its value, the stretches
    run)."""
    spans = _Spans()
    n, send = 1, None
    try:
        while True:
            try:
                req = gen.send(send)
            except StopIteration as stop:
                return stop.value, n
            send = spans.request(req)
            n += 1
    finally:
        spans.close()


def eager(gen):
    """Drives a generator of stretches eagerly; returns its value."""
    out, n = _drive(gen)
    P.count("step_graph_eager", n)
    return out


def _tensors(x):
    """The tensors in a nest of tuples (a scene, a camera)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for y in x:
            yield from _tensors(y)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


class _Entry:
    """One key's graphs: the stretches, the requests between them, the
    buffers."""

    def __init__(self, fn, consts, inputs, aliased, into):
        self.fn = fn
        self.consts = consts  # held: their ids are in the key
        self.aliased = aliased
        self.inputs = tuple(x if a else x.clone() for x, a in zip(inputs, aliased))
        self.graphs, self.requests, self.results = [], [], []
        self.launched = []  # the kernel launches the graphs hold (profiling.launched)
        pool = torch.cuda.graph_pool_handle()
        gen = fn(*consts, *self.inputs)
        spans = _Spans()
        send = None
        try:
            while True:
                g = torch.cuda.CUDAGraph()
                req = done = None
                with P.launch_log() as log, torch.cuda.graph(g, pool=pool):
                    try:
                        req = gen.send(send)
                    except StopIteration as stop:
                        done = _as_tuple(stop.value)
                        if into is not None:
                            for t, o in zip(into, done):
                                t.copy_(o)
                            done = into
                g.replay()
                self.graphs.append(g)
                self.launched += log
                if done is not None:
                    self.outputs = done
                    return
                res = spans.request(req)
                if res is None:
                    static = send = None
                else:
                    static = tuple(r.clone() for r in _as_tuple(res))
                    send = static if isinstance(res, tuple) else static[0]
                self.requests.append(req)
                self.results.append(static)
        finally:
            spans.close()

    def replay(self, inputs):
        for buf, x, a in zip(self.inputs, inputs, self.aliased):
            if not a:
                buf.copy_(x)
        P.count("step_graph_replays", len(self.graphs))
        for counts, k in self.launched:
            counts[k] += 1
        spans = _Spans()
        try:
            for g, req, static in zip(self.graphs, self.requests, self.results):
                g.replay()
                res = spans.request(req)
                if static is not None:
                    for buf, r in zip(static, _as_tuple(res)):
                        buf.copy_(r)
            self.graphs[-1].replay()
        finally:
            spans.close()
        return self.outputs


_CACHE: OrderedDict = OrderedDict()  # key -> _Entry, least recently used first
_OWNER: dict = {}  # data_ptr of an entry's output -> the entry


def clear() -> None:
    """Drops every entry (their graphs and buffers)."""
    _CACHE.clear()
    _OWNER.clear()


def entries() -> int:
    """The number of keys cached."""
    return len(_CACHE)


def _replayable(inputs) -> bool:
    for x in inputs:
        if not isinstance(x, torch.Tensor) or x.device.type != "cuda" or x.requires_grad:
            return False
    return not torch.cuda.is_current_stream_capturing()


def run(fn, consts: tuple, inputs: tuple, into: tuple | None = None):
    """Runs the generator function ``fn(*consts, *inputs)``: by its graphs
    where every input is a CUDA tensor and nothing requires grad, else
    eagerly.  Returns its outputs (a graph run: the entry's buffers, or
    `into`)."""
    if not _replayable(inputs):
        return eager(fn(*consts, *inputs))
    aliased = tuple(getattr(_OWNER.get(x.data_ptr()), "fn", fn) is not fn
                    for x in inputs)
    key = (fn, tuple(map(id, consts)),
           tuple((x.data_ptr() if a else None, tuple(x.shape),
                  x.stride() if a else None, x.dtype, x.device)
                 for x, a in zip(inputs, aliased)),
           None if into is None else tuple(t.data_ptr() for t in into))
    e = _CACHE.get(key)
    if e is None:
        if any(t.requires_grad for t in _tensors(consts)):
            return eager(fn(*consts, *inputs))
        _drive(fn(*consts, *inputs))  # the warm-up
        e = _Entry(fn, consts, inputs, aliased, into)
        P.count("step_graph_captures", len(e.graphs))
        _CACHE[key] = e
        for o in e.outputs:
            _OWNER.setdefault(o.data_ptr(), e)
        _evict()
        return e.outputs
    _CACHE.move_to_end(key)
    return e.replay(inputs)


def _evict():
    while len(_CACHE) > MAX_ENTRIES:
        _, old = _CACHE.popitem(last=False)
        for o in old.outputs:
            if _OWNER.get(o.data_ptr()) is old:
                del _OWNER[o.data_ptr()]
