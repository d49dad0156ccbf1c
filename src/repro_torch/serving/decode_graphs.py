"""Piecewise CUDA graphs of the async decode iteration.

A decode iteration is ``model.decode_pieces``, the stack cut at each
attention layer's paged-decode call, followed by the engine's tail
(``engine.advance``: sampling, the EOS check and the in-place advance of
``last_tok`` and ``pos``). ``DecodeGraphs`` is the one host program of an
unsharded engine's async iteration, and its only switch is whether it
captures. Capturing (the engine's ``_graphed``: on a card), it captures
each piece between two calls once into a ``torch.cuda.CUDAGraph``, all in
one memory pool, and the tail once for each pair of sampling flags
(``FLAGS``). An iteration then replays the pieces in turn, with one eager
``attention.DecodeCall.run`` between each two that writes the
hand-written kernel's output straight into the next piece's static input,
and replays the tail last. Not capturing (off the card, and the card's
equivalence reference), each piece is a plain call of a fresh program
every iteration, through the same static buffers. The kernel stays an
eager wrapper call either way: its launches are counted
(``paged_decode_attention.launches``), its entry can be wrapped from
outside (``econobench/trace.py:record_calls``), and its split counters
serve eager launches on one stream only.

Every tensor a piece reads or writes stays at one address: the params and
caches, the slot state (the engine's own dict, under ``STATE``'s names:
``last_tok``, ``pos``, ``temps``, ``top_ks``, ``eos``, written in place),
the active mask ``active`` (copied in when it changes) and ``stop``, the
megastep's stop flag. An iteration runs the rows ``active & ~stop``. The
context lengths each call takes are computed eagerly, once an iteration:
a fresh tensor, never a graph buffer that a later replay overwrites. When
a param, a cache or a slot-state tensor is rebound, the pieces are
captured again before the next replay. The tails that sample draw from
the engine's generator, registered with their graphs, so a replay draws
what the eager tail would, and ``get_state``/``set_state`` keep their
meaning.

Under ``torch.profiler`` a replay runs inside a ``REPLAY`` op range, so
that the profiler ties the piece's kernels to it as it ties an eager
kernel to its aten op; an op range leaves no shadow on the device
timeline. Code inside a captured piece (``model.moe``'s span) runs at
capture only.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

from ..models import model
from ..obs.spans import current, span

# (need_sample, need_topk) of a tail: what ``sample_in_graph`` can be asked
FLAGS = ((False, False), (True, False), (True, True))
# the slot state a piece reads or writes (``ServingEngine._dev``)
STATE = ("last_tok", "pos", "temps", "top_ks", "eos", "active")
REPLAY = "decode_graphs.replay"


def _replay(g: torch.cuda.CUDAGraph) -> None:
    if _autograd_profiler._is_profiler_enabled:
        with _RecordFunctionFast(REPLAY):
            g.replay()
    else:
        g.replay()


@contextlib.contextmanager
def _captured(g: torch.cuda.CUDAGraph, pool):
    g.capture_begin(pool=pool)
    try:
        yield
    finally:
        g.capture_end()


def _drive(prog, piece, between):
    """Run ``prog`` a piece at a time, each inside ``piece()``; each call
    it yields gets back ``between(call)``. Returns the program's value."""
    sent = None
    while True:
        with piece():
            try:
                call = prog.send(sent)
            except StopIteration as done:
                return done.value
        sent = between(call)


def _ptrs(params, caches, st) -> tuple:
    return (tuple(t.data_ptr() for t in params.values())
            + tuple(t.data_ptr() for sub in caches.values()
                    for t in sub.values())
            + tuple(st[n].data_ptr() for n in STATE))


class DecodeGraphs:
    """The decode iteration of one engine as piecewise graphs (see the
    module). ``state`` is the engine's slot-state dict itself, read under
    ``STATE``'s names at every iteration; ``gen`` is its sampling
    generator; ``advance`` the iteration's tail, (state, gen, logits,
    active, need_sample, need_topk) -> (tokens, eos_hit). ``n_captures``
    counts the captures (each of every piece and tail)."""

    def __init__(self, cfg, state: Dict[str, torch.Tensor],
                 gen: torch.Generator, advance):
        self.cfg = cfg
        self.st = state
        self.gen = gen
        self.advance = advance
        self.stop = torch.zeros((), dtype=torch.bool,
                                device=state["active"].device)
        self.n_captures = 0
        self._ptrs: Optional[tuple] = None
        self._bufs: Dict[tuple, torch.Tensor] = {}
        self._first: Optional[torch.cuda.CUDAGraph] = None
        # (call, its lens key, its output buffer, the next piece's graph)
        self._plan: list = []
        self._tails: Dict[tuple, tuple] = {}
        self._live: tuple = ()

    def _program(self, params, caches):
        """One iteration's pieces up to the logits: (act, logits)."""
        st = self.st
        act = st["active"] & ~self.stop
        logits = yield from model.decode_pieces(
            self.cfg, params, st["last_tok"][:, None], st["pos"], caches,
            active=act)
        return act, logits

    def _buf(self, call) -> torch.Tensor:
        """The static output of a call of this shape (calls run in turn,
        so calls of one shape share it)."""
        key = (tuple(call.q.shape), call.q.dtype)
        buf = self._bufs.get(key)
        if buf is None:
            buf = self._bufs[key] = torch.zeros_like(call.q)
        return buf

    def run(self, params, caches, need_sample: bool, need_topk: bool,
            capture: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """One iteration over the rows ``active & ~stop``, replayed from
        graphs when ``capture`` (captured first where there are none yet,
        or a tensor they hold was rebound), else run as plain calls.
        Returns (tokens, eos_hit): when replayed, static outputs that the
        next iteration overwrites."""
        lens: Dict[tuple, torch.Tensor] = {}

        def call_out(call, key, out):
            n = lens.get(key)
            if n is None:
                n = lens[key] = call.lens()
            return call.run(n, out)

        if not capture:
            act, logits = _drive(
                self._program(params, caches), contextlib.nullcontext,
                lambda c: call_out(c, c.lens_key, self._buf(c)))
            return self.advance(self.st, self.gen, logits, act,
                                need_sample, need_topk)
        ptrs = _ptrs(params, caches, self.st)
        if ptrs != self._ptrs:
            self._capture(params, caches)
            self._ptrs = ptrs
        _replay(self._first)
        for call, key, out, g in self._plan:
            call_out(call, key, out)
            _replay(g)
        g, new, eos_hit = self._tails[(need_sample, need_topk)]
        _replay(g)
        return new, eos_hit

    def _capture(self, params, caches) -> None:
        """Capture every piece and tail on a side stream, after one warm-up
        iteration there with every row off (``stop`` set: no cache, state
        or generator change survives it) and no kernel call (its outputs
        are the zeroed buffers). The generator's state is kept."""
        with span("engine.decode_capture", current()):
            dev = self.stop.device
            if self._first is not None:
                torch.cuda.synchronize(dev)     # no replay still pending
            self._first, self._plan, self._tails, self._live = \
                None, [], {}, ()
            gen0, stop0 = self.gen.get_state(), self.stop.clone()
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.stop.fill_(True)
                act, logits = _drive(self._program(params, caches),
                                     contextlib.nullcontext, self._buf)
                for flags in FLAGS:
                    self.advance(self.st, self.gen, logits, act, *flags)
                self.stop.copy_(stop0)
                pool = torch.cuda.graph_pool_handle()
                graphs, calls = [], []

                def piece():
                    graphs.append(torch.cuda.CUDAGraph())
                    return _captured(graphs[-1], pool)

                def between(call):
                    calls.append(call)
                    return self._buf(call)

                act, logits = _drive(self._program(params, caches), piece,
                                     between)
                for ns, nt in FLAGS:
                    g = torch.cuda.CUDAGraph()
                    if ns:
                        g.register_generator_state(self.gen)
                    with _captured(g, pool):
                        new, eos_hit = self.advance(self.st, self.gen,
                                                    logits, act, ns, nt)
                    self._tails[(ns, nt)] = (g, new, eos_hit)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.gen.set_state(gen0)
            self._first = graphs[0]
            self._plan = [(c, c.lens_key, self._buf(c), g)
                          for c, g in zip(calls, graphs[1:])]
            # act and the logits live from the first piece to the tail
            self._live = (act, logits)
            self.n_captures += 1
