"""Continuous-batching serving engine in PyTorch, driven by the EconoServe
scheduler (``repro_torch.core``, a copy of the reference's).

This is the port of ``repro.serving.engine.ServingEngine``. The scheduler
owns KVC block accounting, batching policy, SLO ordering and KVC
pipelining; the engine owns slots, caches, the prefill and decode calls and
sampling. Its hot path follows the reference's:

  * Decode is asynchronous and device-resident (``EngineConfig
    .async_decode``): per-slot ``last_tok`` / ``pos`` / sampling params are
    tensors on the device, and decode -> sample -> EOS check -> pos update
    run back to back with no host sync. Sampled tokens drain to the host
    through a lag-N ring (``readback_lag``), classified at enqueue time into
    ``sync_counts``. Readiness of a ring entry is a CUDA event's
    ``query()`` (always ready on the CPU).
  * Prefill is token-packed: the iteration's whole prompts run as one
    (1, T) call with per-segment positions and segment ids, then their K/V
    are seeded into the slot rows. The legacy padded path stays behind
    ``packed_prefill=False`` as the equivalence reference. Stacks with
    recurrent blocks (Mamba2, xLSTM, Zamba2's hybrid) prefill each prompt
    at its exact shape instead: a pad token or a foreign segment would
    fold into the recurrent state. MoE stacks run every prefill and chunk
    call at the reference's padded length (``_call_len``): their expert
    capacity depends on it.
  * Sliding-window stacks whose capacity reaches the window keep ring
    caches of window slots: a prompt longer than the window seeds its last
    window tokens at slot p mod window, decode wraps, chunks recompute their
    prefix and no KV image leaves the engine.
  * Chunked prefill executes the scheduler's partial grants: one chunk runs
    over its slot's seeded cache prefix; a wave of >= 2 chunks runs as one
    packed call with per-segment prefix views. Pure-recurrent stacks carry
    a per-request state snapshot across chunks (O(n) in all); hybrid
    stacks, and every stack under ``incremental_chunk_prefill=False``,
    recompute the whole prefix each chunk and reseed the row.
  * Decode megasteps: when the scheduler proves a K-iteration horizon the
    engine runs K iterations back to back in one host loop
    (``_mega_fn``) and replays the K scheduler iterations against the
    (K, B) token matrix.
  * Decode graphs (``decode_graphs.DecodeGraphs``, the async iteration of
    unsharded caches): on a CUDA device an async decode iteration replays
    CUDA graphs of the pieces between its paged-decode calls, captured at
    the first async decode, and calls the hand-written kernel eagerly
    between them; elsewhere the same program runs its pieces as plain
    calls. The legacy sync path and sharded caches run
    ``model.decode_step``.
  * KV migration: ``export_kv`` / ``inject_kv`` move a queued request's
    cache image (CPU tensors with a CRC) and slot state between engines,
    for the fleet's prefill/decode roles, evacuation and crash recovery
    (``repro_torch.cluster``). Recurrent and hybrid stacks have no
    portable image: the receiver recomputes, as the reference's does.

Host spans (``repro_torch.obs.spans``). ``step`` runs, in order and each
at most once: ``engine.admit`` (buffered arrivals, injects and aborts),
``scheduler.form_batch``, ``engine.prefill_wave`` and
``engine.prefill_chunks`` (the flash wrapper's ``kernels.flash_call``
inside), ``engine.decode``, ``scheduler.finish_iteration`` (with the
completions), then ``engine.drain`` for a flush. Inside ``engine.decode``:
``engine.drain`` (the readback ring's device-to-host copy and appends),
``engine.decode_launch`` (one iteration's or one megastep window's
launches, with a ``kernels.decode_call`` a layer, and
``engine.decode_capture`` when the decode graphs are captured),
``engine.eos_readback`` (blocking EOS flag reads) and
``engine.mega_replay`` (the host replay of a window's row). ``model.moe``
sits inside a MoE stack's calls (in a captured decode piece, at the
capture only). With ``engine.spans = SpanTotals()`` each span adds its
host nanoseconds and a call; without totals and profiler a span costs one
flag read. Under ``torch.profiler`` only ``engine.prefill_wave``,
``engine.prefill_chunks``, ``engine.decode`` and ``model.moe`` show as
ranges. The profiler credits a range with the device time of the aten
kernels launched inside it (and of a replayed decode piece's, through the
replay's op range); the two attention kernels, launched through ctypes,
it ties to no op or range.

Each ``GenRequest`` carries host ``time.monotonic()`` stamps of its first
token: ``t_first_sampled`` when the prefill enqueued it into the readback
ring, ``t_first_drained`` when it reached ``output``. With ``t_submit`` and
the scheduler's ``t_start_exec`` they split the time to a first token into
queue, prefill and ring.

Where the reference donates buffers to XLA, this engine updates caches and
slot state in place. Where the reference scatters with ``mode="drop"``
(pad rows at slot ``max_batch``, pad positions at index C), this engine
drops the pad rows on the host before it writes: ``index_put_`` would raise
on them.
"""
from __future__ import annotations

import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..core.costmodel import CostModel, ModelProfile
from ..core.predictor import NoisyPredictor, apply_padding
from ..core.pressure import WatermarkGuard
from ..core.request import Request, State
from ..core.scheduler import SchedulerConfig, make_econoserve
from ..distributed.dtensor import is_dtensor
from ..kernels.ref import POS_INVALID
from ..models import model
from ..models.config import ATTN, ModelConfig
from ..obs import MetricsRegistry, publish_engine
from ..obs.spans import SpanTotals, set_current, span

from .decode_graphs import DecodeGraphs
from .sampling import SamplingParams, sample_in_graph, sample_per_request

MIN_SEQ_BUCKET = 16


class InvalidRequestError(ValueError):
    """Typed rejection for malformed ``GenRequest``s: the engine fails
    fast at ``submit`` instead of surfacing a deep shape error iterations
    later."""


class RequestShed(RuntimeError):
    """Typed admission rejection: the request cannot meet its deadline, so
    it is fast-failed (marked ``status="shed"``) instead of queued into
    certain SLO violation. Carries the request as ``.request``."""

    def __init__(self, request, reason: str):
        super().__init__(reason)
        self.request = request
        self.reason = reason


class FleetStalled(RuntimeError):
    """``serve_stream`` watchdog: work remains but N consecutive steps
    made no progress. Carries a diagnostic snapshot as ``.debug``."""

    def __init__(self, msg: str, debug=None):
        super().__init__(msg)
        self.debug = debug or {}


def kv_checksum(kv: dict) -> int:
    """CRC over a KV image ({kind: {"k", "v"}} of CPU tensors), computed at
    capture and verified at restore: a corrupted image must degrade to
    recompute, never poison a cache."""
    crc = 0
    for kind in sorted(kv):
        for n in ("k", "v"):
            t = kv[kind][n].contiguous()
            crc = zlib.crc32(t.view(torch.uint8).numpy().tobytes(), crc)
    return crc


def seq_bucket(n: int) -> int:
    """Power-of-two padded length (floor MIN_SEQ_BUCKET)."""
    b = MIN_SEQ_BUCKET
    while b < n:
        b <<= 1
    return b


def packed_chunk_layout(starts: Sequence[int], lens: Sequence[int],
                        capacity: int):
    """Layout of a packed chunk wave: chunk i covers [starts[i],
    starts[i] + lens[i]) of its prompt. The query axis concatenates the
    chunks with absolute positions and segment id i; the key axis prepends
    n prefix views of Cp slots, Cp the deepest seeded prefix (at least 1),
    view i valid below starts[i] (POS_INVALID beyond) with segment id i.
    Returns pos, seg (1, T); ppos, pseg (1, n * Cp); offs (n,) the offset
    of each chunk on the query axis."""
    n = len(starts)
    Cp = min(max(max(starts), 1), capacity)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    pos = np.concatenate([s + np.arange(L) for s, L in zip(starts, lens)])
    seg = np.repeat(np.arange(n), lens)
    ppos = np.full((n, Cp), POS_INVALID, np.int32)
    for i, s in enumerate(starts):
        ppos[i, :min(s, Cp)] = np.arange(min(s, Cp))
    pseg = np.repeat(np.arange(n, dtype=np.int32)[:, None], Cp, axis=1)
    return (pos.astype(np.int32)[None], seg.astype(np.int32)[None],
            ppos.reshape(1, n * Cp), pseg.reshape(1, n * Cp), offs)


@dataclass
class EngineConfig:
    """Engine hot-path toggles: the fast paths are the default and
    ``False`` keeps the reference implementation for equivalence tests.

    ``readback_lag`` is how many decode iterations sampled tokens may trail
    on device before the host materializes them; ``max_pending`` caps
    undrained *dispatches* (a K-iteration megastep window counts once).
    ``decode_megastep`` is the max fused decode iterations per window
    (1 = the per-iteration async path; requires ``async_decode``).
    ``incremental_chunk_prefill=False`` makes every chunk recompute its
    whole prefix (the reference path the incremental and state-carry ones
    are held against). ``packed_chunk_prefill=False`` keeps one call per
    chunk. ``host_swap`` captures a de-slotted GT's cache pages to a
    bounded host pool and restores them on next schedule instead of
    recomputing; ``swap_watermarks`` arms the proactive ``WatermarkGuard``.
    """
    async_decode: bool = True
    packed_prefill: bool = True
    readback_lag: int = 2
    max_pending: int = 8
    decode_megastep: int = 8
    incremental_chunk_prefill: bool = True
    packed_chunk_prefill: bool = True
    # --- tiered KVC degradation (host swap + watermark guard) ----------
    host_swap: bool = True
    host_pool_frac: float = 1.0
    swap_watermarks: bool = False
    guard_high: float = 0.92
    guard_low: float = 0.70
    guard_alpha: float = 0.5
    guard_patience: int = 2
    guard_max_swaps: int = 2


@dataclass
class GenRequest:
    prompt: List[int]
    params: SamplingParams = field(default_factory=SamplingParams)
    rid: int = -1
    output: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_done: Optional[float] = None
    # host ``time.monotonic()`` when the first response token was enqueued
    # into the readback ring (the sync path: written to ``output``), and
    # when it was appended to ``output``
    t_first_sampled: Optional[float] = None
    t_first_drained: Optional[float] = None
    # --- fault tolerance / SLO enforcement -----------------------------
    deadline: float = float("inf")   # absolute (iteration-clock) deadline
    status: Optional[str] = None     # terminal: completed | aborted | shed
    fail_reason: Optional[str] = None

    @property
    def finished(self) -> bool:
        return self.status is not None or self.t_done is not None


def resolve_device(device) -> torch.device:
    """``None`` means the card; without one the caller must ask for the
    CPU explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        device = "cuda"
    return torch.device(device)


def advance(st: Dict[str, torch.Tensor], gen: torch.Generator,
            logits: torch.Tensor, active: torch.Tensor, need_sample: bool,
            need_topk: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tail of an async decode iteration over the rows ``active``:
    sampling (inactive rows greedy), the EOS check, and ``last_tok`` and
    ``pos`` advanced in place. Returns (tokens (B,), eos_hit (B,))."""
    temps = torch.where(active, st["temps"], torch.zeros_like(st["temps"]))
    top_ks = torch.where(active, st["top_ks"],
                         torch.zeros_like(st["top_ks"]))
    new = sample_in_graph(logits, gen, temps, top_ks, need_sample, need_topk)
    eos_hit = active & (st["eos"] >= 0) & (new == st["eos"])
    torch.where(active, new, st["last_tok"], out=st["last_tok"])
    st["pos"].add_(active.to(st["pos"].dtype))
    return new, eos_hit


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None, *,
                 max_batch: int = 8, capacity: int = 512,
                 scheduler_cfg: Optional[SchedulerConfig] = None,
                 variant: str = "full", rl_accuracy: float = 0.8,
                 seed: int = 0, engine_cfg: Optional[EngineConfig] = None,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = max_batch
        self.capacity = capacity
        self.ecfg = engine_cfg or EngineConfig()
        dev = self.device
        self.params = params if params is not None else model.init(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        # the sampling generator: seed + 1, as the reference's self.key;
        # the sync and async paths draw from the same stream
        self.gen = torch.Generator(device=dev).manual_seed(seed + 1)

        scfg = scheduler_cfg or SchedulerConfig(
            kvc_tokens=max_batch * capacity, block_size=32,
            tfs=capacity, max_model_len=capacity,
            max_batch_reqs=max_batch)
        cost = CostModel(model=ModelProfile.from_config(cfg))
        self.scheduler = make_econoserve(scfg, cost, variant)
        self.predictor = NoisyPredictor(accuracy=rl_accuracy, seed=seed,
                                        bucket=scfg.bucket)

        # slot-based caches: (n, B, C, K, hd) K/V leaves, (n, B, ...)
        # recurrent states
        self.caches = model.init_cache(cfg, max_batch, capacity, device=dev)
        self.slot_of: Dict[int, int] = {}
        self.free_slots = list(range(max_batch))
        # host mirrors of per-slot state. On the legacy sync path they are
        # authoritative; on the async path last_tok/pos live on the device
        # and the mirrors only hold prefill-time values
        self.pos = np.zeros(max_batch, np.int64)      # next absolute position
        self.last_tok = np.zeros(max_batch, np.int64)
        self.temps = np.zeros(max_batch, np.float32)  # per-slot sampling
        self.top_ks = np.zeros(max_batch, np.int32)
        self.requests: Dict[int, GenRequest] = {}
        self._rid = 0

        # padded and token-packed prefill are exact only for pure-attention
        # stacks (masking ignores pad positions and foreign segments);
        # recurrent blocks would fold them into their state, so they get
        # exact shapes
        self._pad_prefill = set(cfg.pattern()) <= {ATTN}
        self._async = self.ecfg.async_decode
        self._packed = self.ecfg.packed_prefill and self._pad_prefill
        self._prefill_shapes: Set[Tuple[int, int]] = set()
        # chunks attend over the seeded cache prefix (pure attention with
        # non-ring caches: a ring prefix has no identity-placement view), or
        # carry the recurrent-state snapshot (pure-recurrent stacks), or
        # recompute their whole prefix (hybrid stacks, ring caches; and
        # every stack when incremental_chunk_prefill is off)
        win = cfg.sliding_window
        self._chunk_incremental = (self.ecfg.incremental_chunk_prefill
                                   and self._pad_prefill
                                   and (win is None or capacity < win))
        self._chunk_packed = (self.ecfg.packed_chunk_prefill
                              and self._chunk_incremental and self._packed)
        self._chunk_rec = (self.ecfg.incremental_chunk_prefill
                           and ATTN not in cfg.pattern()
                           and not model.num_shared_invocations(cfg))
        self._rec_state: Dict[int, dict] = {}       # rid -> state snapshot
        self._chunk_progress: Dict[int, int] = {}   # rid -> ctx tokens seeded
        self.n_prefill_chunks = 0
        self.n_chunk_calls = 0                      # chunk-prefill dispatches
        self.max_chunk_items_per_call = 0
        # decode megastep: K iterations per window (async only)
        self._mega_max = max(1, int(self.ecfg.decode_megastep)) \
            if self.ecfg.async_decode else 1
        self._mega_toks: Optional[torch.Tensor] = None  # (Kmax, B) window
        self._mega_eos: Optional[np.ndarray] = None     # host (Kmax, B)
        self._mega_row = 0
        self._mega_left = 0
        self.n_mega_windows = 0                     # windows with K > 1
        # arrivals submitted while a window is open wait here, as do
        # aborts (mutating batch membership mid-window would desync the
        # device state the window already computed against)
        self._arrivals: List[Tuple[Request, float]] = []
        self._pending_injects: List[Tuple[dict, float]] = []
        self._pending_aborts: List[Tuple[int, float, str]] = []
        self.n_decode_dispatches = 0
        self.n_kv_exports = 0
        self.n_kv_injects = 0
        self.n_kv_rejects = 0
        self.n_export_reads = 0      # blocking device reads by export_kv
        self.n_aborted = 0
        self.n_shed = 0              # rung-4 terminal sheds (kvc-infeasible)
        self.n_prefill_waves = 0     # whole-prompt prefill dispatch waves

        # idempotent at-least-once delivery (see the reference)
        self._delivered: set = set()
        self.n_dup_deliveries = 0
        self.n_dup_completions = 0
        self.fleet_shed_handback = False
        self.shed_handback: List[GenRequest] = []

        # host-offload KV swap tier (rung 2): rid -> {"kv", "ctx", "crc"}
        # images of CPU tensors, budgeted by the BlockKVC swap ledger
        self._host_swap: Dict[int, dict] = {}
        kvc = self.scheduler.kvc
        kvc.host_pool_tokens = int(kvc.capacity_tokens
                                   * max(0.0, self.ecfg.host_pool_frac))
        self.guard = WatermarkGuard(
            high=self.ecfg.guard_high, low=self.ecfg.guard_low,
            alpha=self.ecfg.guard_alpha,
            patience=self.ecfg.guard_patience) \
            if self.ecfg.swap_watermarks else None
        self.n_swap_captures = 0
        self.n_swap_restores = 0
        self.n_swap_rejects = 0
        self.n_swap_drops = 0
        self._pending_squeeze = 0.0

        # async bookkeeping: device slot state carried across iterations,
        # plus the lag-N readback ring
        self._dev = {
            "last_tok": torch.zeros(max_batch, dtype=torch.int32, device=dev),
            "pos": torch.zeros(max_batch, dtype=torch.int32, device=dev),
            "temps": torch.zeros(max_batch, dtype=torch.float32, device=dev),
            "top_ks": torch.zeros(max_batch, dtype=torch.int32, device=dev),
            "eos": torch.full((max_batch,), -1, dtype=torch.int32,
                              device=dev),
            # the decode rows, copied in when they change
            "active": torch.zeros(max_batch, dtype=torch.bool, device=dev),
        }
        self._active_bytes: Optional[bytes] = None
        # the async iteration of unsharded caches, over ``_dev`` at fixed
        # addresses; captured into CUDA graphs on a card (``_graphed``,
        # which the graphs' equivalence tests clear to run its pieces as
        # plain calls there too)
        self._decode_graphs = DecodeGraphs(
            cfg, self._dev, self.gen, advance) if self._async and not any(
                is_dtensor(t) for sub in self.caches.values()
                for t in sub.values()) else None
        self._graphed = self._decode_graphs is not None and \
            dev.type == "cuda"
        self.n_graphed_decode_iters = 0
        # ring entries: (tokens, row, [(slot_row, rid)], ready event).
        # ``tokens`` is a (B,) sampled batch (row None) or a (Kmax, B)
        # megastep window shared by K entries, ``row`` selecting the
        # iteration; the event (None on the CPU) marks the dispatch's end
        self._pending_drain: Deque[Tuple[torch.Tensor, Optional[int],
                                         List[Tuple[int, int]],
                                         Optional[torch.cuda.Event]]] = deque()
        self._last_event: Optional[torch.cuda.Event] = None
        # host-sync instrumentation, classified at enqueue time exactly as
        # the reference (eos_flags, drain_blocking, drain_backpressure,
        # drain_ready, flush)
        self.sync_counts = {"eos_flags": 0, "drain_blocking": 0,
                            "drain_backpressure": 0,
                            "drain_ready": 0, "flush": 0}
        self._drain_seq = 0
        self._recent_drain_seqs: Deque[int] = deque(
            maxlen=max(1, self.ecfg.readback_lag))
        self.n_tokens_drained = 0
        self.decode_iters = 0
        # metrics hook: an attached sampler's on_step(engine, now) runs at
        # the end of every step (host-side reads only)
        self.metrics = None
        # host span totals (``repro_torch.obs.spans``): None collects none
        self.spans: Optional[SpanTotals] = None

    # ------------------------------------------------------------------ #
    # device programs (the reference's jitted functions)
    # ------------------------------------------------------------------ #
    def _t(self, a, dtype=None) -> torch.Tensor:
        """A host array as a tensor on the engine's device."""
        t = torch.as_tensor(np.asarray(a))
        if dtype is not None:
            t = t.to(dtype)
        return t.to(self.device)

    @property
    def n_decode_captures(self) -> int:
        """Captures of the decode graphs (each of every piece and tail)."""
        g = self._decode_graphs
        return 0 if g is None else g.n_captures

    def _one_iter(self, active: torch.Tensor, need_sample: bool,
                  need_topk: bool):
        """One async decode iteration: forward pass with the cache write
        masked to active rows, sampling, EOS check and pos advance — shared
        by the single-step path and the megastep loop. Updates ``caches``
        and ``_dev`` in place; returns (tokens, eos_hit). Through the decode
        graphs ``active`` is ``_dev["active"]``, the rows run are ``active
        & ~graphs.stop``, and a replay returns the graphs' outputs, which
        the next iteration overwrites. Sharded caches run
        ``model.decode_step``."""
        graphs = self._decode_graphs
        if graphs is not None:
            return graphs.run(self.params, self.caches, need_sample,
                              need_topk, self._graphed)
        logits, _ = model.decode_step(self.cfg, self.params,
                                      self._dev["last_tok"][:, None],
                                      self._dev["pos"], self.caches,
                                      active=active)
        return advance(self._dev, self.gen, logits, active, need_sample,
                       need_topk)

    def _mega_fn(self, active: torch.Tensor, k_iters: int, need_sample: bool,
                 need_topk: bool, stop_on_eos: bool):
        """Decode megastep: ``k_iters`` iterations of ``_one_iter`` in one
        host loop (the reference runs them as one ``lax.while_loop``),
        collecting each iteration's tokens and EOS flags into (Kmax, B)
        buffers.

        ``stop_on_eos``: under memory pressure the reference exits its loop
        after the iteration where EOS fired. Here a device stop flag masks
        every later iteration to no active rows, so caches, ``pos`` and
        ``last_tok`` advance exactly as on the K=1 path, and rows past the
        stop stay zero. With the decode graphs the flag is the graphs'
        ``stop``, cleared again after the window.

        The K=1 path draws from ``self.gen`` in each iteration where a live
        row samples; a window draws in each of its iterations when a row
        samples, also in masked ones and after the last sampling row's EOS.
        So when a row samples, the generator's state after each iteration
        is kept (``gen_states``, else None: host-side seed and offset, no
        device read), and ``_rewind_gen`` restores the right one once the
        window's EOS readback is in. Returns (tokens, eos flags,
        gen_states)."""
        B = self.max_batch
        tb = torch.zeros((self._mega_max, B), dtype=torch.int32,
                         device=self.device)
        eb = torch.zeros((self._mega_max, B), dtype=torch.bool,
                         device=self.device)
        graphs = self._decode_graphs
        stop = torch.zeros((), dtype=torch.bool, device=self.device) \
            if graphs is None else graphs.stop
        gen_states = [] if need_sample else None
        for i in range(k_iters):
            act = active & ~stop if stop_on_eos and graphs is None \
                else active
            new, eos_hit = self._one_iter(act, need_sample, need_topk)
            tb[i] = torch.where(stop, torch.zeros_like(new), new) \
                if stop_on_eos else new
            eb[i] = eos_hit
            if stop_on_eos:
                stop.logical_or_(eos_hit.any())
            if gen_states is not None:
                gen_states.append(self.gen.get_state())
        if stop_on_eos and graphs is not None:
            stop.zero_()
        return tb, eb, gen_states

    def _seed_slots(self, slots, first: torch.Tensor, fallback, use_first,
                    poss, temps, top_ks, eos) -> None:
        """Write prefill results into the device slot state (async path):
        the first sampled token stays on the device; rows re-prefilled
        after a preemption restore their last token from the host-known
        ``fallback``. Pad rows (slot ``max_batch``) are dropped here."""
        slots = np.asarray(slots)
        keep = np.nonzero(slots < self.max_batch)[0]
        if keep.size == 0:
            return
        idx = self._t(slots[keep], torch.long)
        sel = lambda a: np.asarray(a)[keep]
        kt = self._t(keep, torch.long)
        last = torch.where(self._t(sel(use_first)), first[kt].to(torch.int32),
                           self._t(sel(fallback), torch.int32))
        st = self._dev
        st["last_tok"][idx] = last
        st["pos"][idx] = self._t(sel(poss), torch.int32)
        st["temps"][idx] = self._t(sel(temps), torch.float32)
        st["top_ks"][idx] = self._t(sel(top_ks), torch.int32)
        st["eos"][idx] = self._t(sel(eos), torch.int32)

    def _is_ring(self, kind: str) -> bool:
        """A cache row is a sliding-window ring buffer when its capacity
        equals the window (shared-attention caches are always full size)."""
        win = self.cfg.sliding_window
        return (kind == ATTN and win is not None
                and self.caches[kind]["k"].shape[2] == win)

    def _write_rows(self, src: Dict[str, Dict[str, torch.Tensor]],
                    spans) -> None:
        """One in-place scatter per K/V cache leaf, with src leaves
        (n, N, K, hd). ``spans`` holds (slot, start, length, offset) for the
        real tokens only (pad rows and pad positions are dropped on the
        host): token j of a span is at absolute position start + j and at
        src index offset + j. A C-slot cache holds position p at slot p;
        a ring (``_is_ring``) keeps each span's last C positions, at slot
        p mod C (the reference's ``_ring_index``). The index arrays are
        built from host lengths: no device read."""
        for kind in model.KV_KINDS:
            if kind not in self.caches:
                continue
            C = self.caches[kind]["k"].shape[2]
            ring = self._is_ring(kind)
            si, pi, ri = [], [], []
            for slot, start, L, off in spans:
                p = np.arange(max(start, start + L - C) if ring else start,
                              start + L)
                si.append(np.full(p.size, slot))
                pi.append(p % C if ring else p)
                ri.append(off + p - start)
            si, pi, ri = (self._t(np.concatenate(a), torch.long)
                          for a in (si, pi, ri))
            for n in ("k", "v"):
                dst = self.caches[kind][n]
                dst[:, si, pi] = src[kind][n][:, ri].to(dst.dtype)

    def _call_len(self, n: int, room: Optional[int] = None) -> int:
        """Token count of a prefill or chunk call of ``n`` real tokens: n
        (exact shapes), or for a MoE stack the reference's padded length
        (``seq_bucket(n)``, capped at ``room`` cache slots where the
        reference caps it). A MoE's expert capacity grows with the call's
        token count (``moe.capacity``), so an exact-length call would drop
        tokens the reference keeps. Pad tokens follow the real ones, so
        only their count reaches the real tokens' routing."""
        if not self.cfg.is_moe:
            return n
        b = seq_bucket(n)
        return b if room is None or b <= room else max(n, room)

    def _prefill_packed(self, toks, pos, seg, last_idx):
        """Token-packed prefill: toks/pos/seg (1, T). Only the rows at
        ``last_idx`` reach the head (the reference computes logits for all
        T tokens and then picks them; the values are the same)."""
        x, caches = model.prefill_hidden(
            self.cfg, self.params, self._t(toks, torch.long),
            positions=self._t(pos, torch.int32),
            segment_ids=self._t(seg, torch.int32))
        last = model.logits_fn(self.cfg, self.params,
                               x[0, self._t(last_idx, torch.long)])
        return last, caches

    def _prefill(self, toks, lens):
        """Prefill of (Bb, Sb) rows with implicit positions: the legacy
        padded path, or an exact-shape call (recurrent stacks)."""
        x, caches = model.prefill_hidden(self.cfg, self.params,
                                         self._t(toks, torch.long))
        rows = torch.arange(x.shape[0], device=self.device)
        last = model.logits_fn(self.cfg, self.params,
                               x[rows, self._t(np.asarray(lens) - 1,
                                               torch.long)])
        return last, caches

    def _seed_packed(self, pf_caches, slots, starts, lens) -> None:
        """Seed decode caches from a token-packed prefill: item i's span
        [starts[i], starts[i] + lens[i]) of the packed axis holds positions
        [0, lens[i]) of its slot's row. Cache slots past a row's length
        keep stale values that decode masking never reads (the reference
        fills them with copies of the last token, equally unread)."""
        src = {ATTN: {n: pf_caches[ATTN][n][:, 0] for n in ("k", "v")}}
        self._write_rows(src, [(s, 0, L, st) for s, st, L
                               in zip(slots, starts, lens)
                               if s < self.max_batch])

    def _seed(self, pf_caches, slots, lens) -> None:
        """Seed decode caches from a prefill batch: K/V leaves
        (n, Bb, S, K, hd) put row i's first lens[i] positions in its slot;
        recurrent leaves (n, Bb, ...) are a plain row scatter. Pad rows
        (slot ``max_batch``) are dropped."""
        keep = [i for i, s in enumerate(slots) if s < self.max_batch]
        kv = [kind for kind in model.KV_KINDS if kind in pf_caches]
        if kv:
            S = pf_caches[kv[0]]["k"].shape[2]
            self._write_rows(
                {kind: {n: pf_caches[kind][n].flatten(1, 2)
                        for n in ("k", "v")} for kind in kv},
                [(slots[i], 0, lens[i], i * S) for i in keep])
        rows = self._t([slots[i] for i in keep], torch.long)
        ri = self._t(keep, torch.long)
        for kind, sub in self.caches.items():
            if kind in model.KV_KINDS:
                continue
            for n, dst in sub.items():
                dst[:, rows] = pf_caches[kind][n][:, ri].to(dst.dtype)

    def _chunk_prefill(self, toks, pos, slot: int, start: int, length: int):
        """Incremental chunk prefill + in-place seed: the chunk's queries
        attend over the slot's seeded cache prefix (slots [0, start)), and
        the chunk's K/V land at [start, start + length) of the same row.
        Returns the last real token's logits."""
        prefix = {ATTN: {n: self.caches[ATTN][n][:, slot:slot + 1]
                         for n in ("k", "v")}}
        x, pf = model.prefill_hidden(
            self.cfg, self.params, self._t(toks, torch.long),
            positions=self._t(pos, torch.int32), prefix_caches=prefix,
            prefix_len=start)
        last = model.logits_fn(self.cfg, self.params, x[0, length - 1])
        for nm in ("k", "v"):
            dst = self.caches[ATTN][nm]
            dst[:, slot, start:start + length] = \
                pf[ATTN][nm][:, 0, :length].to(dst.dtype)
        return last

    def _chunks_packed(self, toks, pos, seg, ppos, pseg, slots, last_idx,
                       starts, lens, offs):
        """Packed multi-request chunk prefill + seed: one (1, T) call whose
        key axis prepends every segment's own cache-prefix view (gathered
        from the caches, masked per slot by ``ppos``/``pseg``); each chunk's
        K/V then land in its slot's row at [start, start + len)."""
        n = len(slots)
        Cp = ppos.shape[1] // n
        st = self._t(slots, torch.long)
        prefix = {}
        for nm in ("k", "v"):
            rows = self.caches[ATTN][nm][:, st, :Cp]      # (L, n, Cp, K, hd)
            L, _, _, Kh, hd = rows.shape
            prefix[nm] = rows.reshape(L, 1, n * Cp, Kh, hd)
        x, pf = model.prefill_hidden(
            self.cfg, self.params, self._t(toks, torch.long),
            positions=self._t(pos, torch.int32),
            segment_ids=self._t(seg, torch.int32),
            prefix_caches={ATTN: prefix},
            prefix_positions=self._t(ppos, torch.int32),
            prefix_segment_ids=self._t(pseg, torch.int32))
        last = model.logits_fn(self.cfg, self.params,
                               x[0, self._t(last_idx, torch.long)])
        self._write_rows({ATTN: {nm: pf[ATTN][nm][:, 0]
                                 for nm in ("k", "v")}},
                         list(zip(slots, starts, lens, offs)))
        return last

    def _inject_seed(self, kv: dict, slot: int, ctx: int) -> None:
        """Seed a captured KV image (CPU tensors (L, ctx, K, hd)) into one
        cache row."""
        for n in ("k", "v"):
            dst = self.caches[ATTN][n]
            dst[:, slot, :ctx] = kv[ATTN][n].to(self.device, dst.dtype)

    def _record_event(self) -> Optional[torch.cuda.Event]:
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @property
    def n_prefill_compiles(self) -> int:
        """Distinct (batch, seq) prefill shapes run so far."""
        return len(self._prefill_shapes)

    @property
    def n_blocking_syncs(self) -> int:
        """Host syncs that can leave the device idle (EOS-flag readbacks +
        pipeline-serializing token drains)."""
        return (self.sync_counts["eos_flags"]
                + self.sync_counts["drain_blocking"])

    # ------------------------------------------------------------------ #
    def submit(self, req: GenRequest, now: float,
               dkey: Optional[tuple] = None) -> int:
        """Register a request. While a megastep window is open the
        scheduler must not see the arrival: it is buffered with its true
        arrival time and delivered when the window drains. ``dkey`` drops a
        duplicated delivery (returns -1)."""
        if dkey is not None:
            if dkey in self._delivered:
                self.n_dup_deliveries += 1
                return -1
            self._delivered.add(dkey)
        self.validate(req)
        req.rid = self._rid
        self._rid += 1
        req.t_submit = now
        r = Request(rid=req.rid, prompt_len=len(req.prompt),
                    true_rl=req.params.max_new_tokens, arrival=now,
                    slo_deadline=req.deadline)
        r.predicted_rl = self.predictor.predict(r)
        r.padded_rl = apply_padding(r.predicted_rl,
                                    self.scheduler.cfg.pad_ratio,
                                    self.scheduler.cfg.bucket)
        self.requests[req.rid] = req
        if self._mega_left > 0:
            self._arrivals.append((r, now))
        else:
            self.scheduler.on_arrival(r, now)
        return req.rid

    def validate(self, req: GenRequest) -> None:
        """Reject malformed requests with a typed error at submit."""
        if req.params.max_new_tokens <= 0:
            raise InvalidRequestError(
                f"max_new_tokens must be >= 1, got "
                f"{req.params.max_new_tokens}")
        if not req.prompt:
            raise InvalidRequestError("empty prompt")
        kvc_cap = self.scheduler.kvc.capacity_tokens
        if len(req.prompt) + 1 > min(self.capacity, kvc_cap):
            raise InvalidRequestError(
                f"prompt of {len(req.prompt)} tokens (+1 response token) "
                f"exceeds capacity (cache row {self.capacity} slots, "
                f"KVC {kvc_cap} tokens)")
        if not all(0 <= t < self.cfg.vocab_size for t in req.prompt):
            raise InvalidRequestError("prompt token out of vocabulary")

    def has_work(self) -> bool:
        return (self.scheduler.has_work() or bool(self._arrivals)
                or bool(self._pending_injects)
                or bool(self._pending_aborts))

    # ------------------------------------------------------------------ #
    # abort / cancellation
    # ------------------------------------------------------------------ #
    def abort(self, rid: int, now: float, reason: str = "aborted") -> bool:
        """Cancel an in-flight request (force-draining the token ring
        first); deferred while a megastep window is open. Returns True when
        applied or queued, False when unknown or already terminal."""
        g = self.requests.get(rid)
        if g is None or g.finished:
            return False
        if self._mega_left > 0:
            if not any(p[0] == rid for p in self._pending_aborts):
                self._pending_aborts.append((rid, now, reason))
            return True
        self._apply_abort(rid, now, reason)
        return True

    def _apply_abort(self, rid: int, now: float, reason: str) -> None:
        assert self._mega_left == 0, "abort applied inside an open window"
        g = self.requests.get(rid)
        if g is None or g.finished:
            return                    # completed while the abort waited
        if self._pending_drain:
            self.sync_counts["flush"] += 1
            self._drain_tokens(force=True)
        for k, (r, _) in enumerate(self._arrivals):
            if r.rid == rid:          # still buffered behind a window
                self._arrivals.pop(k)
                break
        else:
            self.scheduler.cancel(rid, now)
        slot = self.slot_of.pop(rid, None)
        if slot is not None:
            self.free_slots.append(slot)
        self._chunk_progress.pop(rid, None)
        self._rec_state.pop(rid, None)
        self._host_swap.pop(rid, None)
        g.status = "aborted"
        g.fail_reason = reason
        self.n_aborted += 1

    # ------------------------------------------------------------------ #
    # KV migration (cluster disaggregated prefill/decode roles)
    # ------------------------------------------------------------------ #
    @property
    def can_migrate_kv(self) -> bool:
        """A portable KV image needs identity cache placement: an
        attention-pure stack (recurrent states are not positionally
        addressable the same way) and non-ring caches (a sliding-window
        ring's layout depends on this engine's capacity)."""
        win = self.cfg.sliding_window
        return self._pad_prefill and (win is None or self.capacity < win)

    def _capture_kv(self, slot: int, ctx: int) -> dict:
        """Copy one slot's first ``ctx`` cache positions to CPU tensors
        (L, ctx, K, hd). On a CUDA cache the copy waits for the slot's
        dispatched work; on a CPU cache ``copy=True`` keeps the image from
        aliasing a row the slot's next tenant overwrites."""
        return {kind: {n: sub[n][:, slot, :ctx].to("cpu", copy=True)
                       for n in ("k", "v")}
                for kind, sub in self.caches.items()}

    def export_kv(self, rid: int) -> dict:
        """Extract a queued GT's KV pages and carried slot state so a peer
        engine can continue decoding it, and remove the request from this
        engine and its scheduler. The payload feeds ``inject_kv``;
        ``payload["kv"]`` is the {kind: {"k", "v"}} image of the first
        ``ctx`` cache positions as CPU tensors, or None when the request
        lost its slot and no host-pool image of the right extent survives,
        or the stack is recurrent or hybrid (the receiver then recomputes,
        like a swap-preempted GT).

        Must not be called while a megastep window is open: freeing the
        request's KVC mid-window could admit a waiter the window never saw
        (``submit``/``inject_kv`` defer for the same reason). On the async
        path the slot's ``pos`` and ``last_tok`` are read from the device
        in one blocking copy, which ``sync_counts`` do not count (as the
        reference's ``device_get``); ``n_export_reads`` counts it."""
        assert self._mega_left == 0, \
            "export_kv during an open megastep window"
        sched = self.scheduler
        req = next(r for r in sched.gt_queue if r.rid == rid)
        if self._pending_drain:
            # the payload must carry every token generated so far (the
            # receiver's recompute fallback rebuilds context from g.output)
            self.sync_counts["flush"] += 1
            self._drain_tokens(force=True)
        g = self.requests.pop(rid)
        slot = self.slot_of.pop(rid, None)
        kv = crc = None
        if slot is not None:
            if self._async:
                self.n_export_reads += 1
                ctx, last = torch.stack([self._dev["pos"][slot],
                                         self._dev["last_tok"][slot]]
                                        ).tolist()
            else:
                ctx, last = int(self.pos[slot]), int(self.last_tok[slot])
            if self.can_migrate_kv:
                kv = self._capture_kv(slot, ctx)
                crc = kv_checksum(kv)
            self.free_slots.append(slot)
        else:
            ctx = req.prompt_len + req.generated - 1
            last = g.output[req.generated - 1]
            # a host-pool image survives the slot loss: ship it with its
            # capture-time CRC (recomputing it here would vouch for a
            # corrupted pool)
            img = self._host_swap.pop(rid, None)
            if (img is not None and self.can_migrate_kv
                    and img["ctx"] == ctx):
                kv, crc = img["kv"], img["crc"]
        sched.gt_queue.remove(req)
        sched.kvc.free(rid)
        sched.kvc.swap_release(rid)
        sched.swap_hold.pop(rid, None)
        self._chunk_progress.pop(rid, None)
        self._rec_state.pop(rid, None)
        self._host_swap.pop(rid, None)
        req.occupied_kvc = req.prompt_len + req.generated
        self.n_kv_exports += 1
        return {"gen": g, "req": req, "kv": kv, "ctx": ctx,
                "last_tok": last, "kv_crc": crc}

    def inject_kv(self, payload: dict, now: float) -> Optional[int]:
        """Receive a migrated request. With a KV image (and a free slot and
        KVC room) it becomes a queued GT whose decode continues from the
        injected pages; otherwise it queues with its KV "in host memory"
        and the swap-recompute path re-prefills prompt + generated on first
        schedule. A duplicated delivery (its ``dkey`` already accepted) is
        dropped here, before deferral; while a megastep window is open the
        inject waits for the window to drain. Returns the assigned rid, or
        None when deferred or dropped."""
        dkey = payload.get("dkey")
        if dkey is not None:
            if dkey in self._delivered:
                self.n_dup_deliveries += 1
                return None
            self._delivered.add(dkey)
        if self._mega_left > 0:
            self._pending_injects.append((payload, now))
            return None
        return self._apply_inject(payload, now)

    def _apply_inject(self, payload: dict, now: float) -> int:
        """Register a migrated request. A KV image is written straight into
        cache positions [0, ctx) of a free slot: the reference pads it to
        ``seq_bucket(ctx)`` only so that XLA compiles fewer programs, and an
        eager write needs no pad."""
        g: GenRequest = payload["gen"]
        req: Request = payload["req"]
        rid = self._rid
        self._rid += 1
        g.rid = rid
        req.rid = rid
        self.requests[rid] = g
        sched = self.scheduler
        tokens = req.prompt_len + req.generated
        kv = payload["kv"]
        ctx = payload["ctx"]
        if kv is not None:
            crc = payload.get("kv_crc")
            if crc is not None and kv_checksum(kv) != crc:
                # corrupted in transit: refuse the image and recompute from
                # the host-side token stream, the ground truth
                kv = None
                self.n_kv_rejects += 1
        if (kv is not None and self.can_migrate_kv and self.free_slots
                and ctx <= self.capacity and sched.kvc.can_allocate(tokens)):
            sched.kvc.allocate(rid, tokens)
            sched.kvc.set_used(rid, tokens)
            self._seat_image(g, kv, ctx, payload["last_tok"])
        else:
            # swap-recompute fallback: the request queues holding no KVC;
            # scheduled, it arrives in plan.decode_reqs without a slot and
            # the engine re-prefills prompt + generated
            req.prompt_done = req.prompt_len
        req.occupied_kvc = tokens
        req.set_state(State.QUEUED_GT, now)
        sched.enqueue_gt(req)
        self.n_kv_injects += 1
        return rid

    def _seat_image(self, g: GenRequest, kv: dict, ctx: int,
                    last: int) -> None:
        """Give ``g`` a free slot seeded from a KV image of ``ctx``
        positions, with ``last`` as its pending decode input (shared by the
        host-swap restore and the migration inject)."""
        slot = self.free_slots.pop()
        self.slot_of[g.rid] = slot
        self._inject_seed(kv, slot, ctx)
        self.temps[slot] = g.params.temperature
        self.top_ks[slot] = g.params.top_k
        self.pos[slot] = ctx
        if self._async:
            eos = -1 if g.params.eos_token is None else g.params.eos_token
            one = torch.tensor([last], dtype=torch.int32, device=self.device)
            self._seed_slots(np.asarray([slot]), one, [last], [False],
                             [ctx], [g.params.temperature],
                             [g.params.top_k], [eos])
        else:
            self.last_tok[slot] = last

    # ------------------------------------------------------------------ #
    # host-offload KV swap tier (pressure ladder rung 2)
    # ------------------------------------------------------------------ #
    def _core_req(self, rid: int):
        q = self.scheduler.gt_queue
        get = getattr(q, "get", None)
        if get is not None:
            return get(rid)
        return next((r for r in q if r.rid == rid), None)

    def _swap_out(self, rid: int, slot: int) -> None:
        """Rung-2 capture: copy a de-slotted GT's live cache pages to the
        bounded host pool before the slot is recycled; a refused capture
        falls through to recompute."""
        if not (self.ecfg.host_swap and self.can_migrate_kv):
            return
        req = self._core_req(rid)
        if (req is None or req.prompt_done != req.prompt_len
                or req.generated < 1):
            return                     # offload-free preempt or terminal
        # the newest sampled token's KV was never written to cache — it is
        # the pending decode input
        ctx = req.prompt_len + req.generated - 1
        if ctx <= 0 or ctx > self.capacity:
            return
        evicted = self.scheduler.kvc.swap_register(rid, ctx)
        if evicted is None:
            self.n_swap_drops += 1     # budget refusal -> recompute rung
            return
        for old in evicted:
            self._host_swap.pop(old, None)
        # the copy waits for the slot's dispatched work (a sync paid only
        # on the preemption path)
        kv = self._capture_kv(slot, ctx)
        self._host_swap[rid] = {"kv": kv, "ctx": ctx,
                                "crc": kv_checksum(kv)}
        self.n_swap_captures += 1

    def _swap_in(self, missing: List[Request], now: float) -> List[Request]:
        """Rung-2 restore: re-seed scheduled GTs whose pages are in the
        host pool instead of recomputing them. Returns the requests left to
        recompute."""
        sched = self.scheduler
        left = []
        for r in missing:
            img = self._host_swap.pop(r.rid, None)
            if img is None:
                sched.kvc.swap_release(r.rid)
                left.append(r)
                continue
            ctx = img["ctx"]
            ok = (self.can_migrate_kv and bool(self.free_slots)
                  and 0 < ctx <= self.capacity and r.generated >= 1
                  and kv_checksum(img["kv"]) == img["crc"])
            sched.kvc.swap_release(r.rid, restored=ok)
            if not ok:
                self.n_swap_rejects += 1
                left.append(r)
                continue
            g = self.requests[r.rid]
            self._seat_image(g, img["kv"], ctx, g.output[r.generated - 1])
            t_in = sched.cost.swap_in_time(ctx)
            sched.pending_extra_time += t_in
            r.swap_time += t_in
            self.n_swap_restores += 1
        return left

    def _guard_step(self, now: float) -> None:
        """Watermark-guard observation at a window boundary."""
        sched = self.scheduler
        if sched.kvc.total_blocks <= 0:
            return
        if self.guard.observe(sched.kvc.allocated_frac):
            for v in sched.swap_victims(self.ecfg.guard_max_swaps):
                sched.guard_swap_out(v, now)
                slot = self.slot_of.pop(v.rid, None)
                if slot is not None:
                    self.free_slots.append(slot)
                    self._chunk_progress.pop(v.rid, None)
                    self._rec_state.pop(v.rid, None)
                    self._swap_out(v.rid, slot)
        elif sched.swap_hold:
            sched.release_swap_holds()

    def squeeze_kvc(self, frac: float) -> int:
        """Chaos ``squeeze``: permanently remove ``frac`` of the KVC
        capacity; deferred while a megastep window is open. Returns blocks
        removed immediately (0 when deferred)."""
        if self._mega_left > 0:
            self._pending_squeeze += float(frac)
            return 0
        kvc = self.scheduler.kvc
        return kvc.shrink(int(kvc.capacity_tokens * frac))

    # ------------------------------------------------------------------ #
    def _run_prefill(self, items, now: float, missing=()) -> None:
        """Execute an iteration's PT items and seed their cache slots:
        whole prompts (plus ``missing`` recompute re-prefills) as ONE call,
        partial grants through ``_run_chunk_items``."""
        whole = [(r, r.prompt_len) for r in missing]
        chunked = []
        for r, chunk in items:
            if (r.rid not in self._chunk_progress and r.prompt_done == 0
                    and chunk >= r.prompt_len):
                whole.append((r, chunk))
            else:
                chunked.append((r, chunk))
        if whole:
            self.n_prefill_waves += 1
            # one call for the wave, or one exact-shape call per prompt
            groups = [whole] if self._pad_prefill else [[it] for it in whole]
            with span("engine.prefill_wave", self.spans):
                for group in groups:
                    self._prefill_group(group, now)
        if chunked:
            with span("engine.prefill_chunks", self.spans):
                self._run_chunk_items(chunked, now)

    def _prefill_group(self, group, now: float) -> None:
        ctxs, slots = [], []
        for r, chunk in group:
            assert chunk == r.prompt_len, \
                "partial chunks are routed through _run_chunk_items"
            g = self.requests[r.rid]
            # after an offload-free preemption the context to recompute is
            # prompt + generated-so-far minus the newest token (its KV was
            # never in cache: it stays the pending decode input)
            ctxs.append(list(g.prompt) + g.output[:max(0, r.generated - 1)])
            slot = self.free_slots.pop()
            self.slot_of[r.rid] = slot
            self.temps[slot] = g.params.temperature
            self.top_ks[slot] = g.params.top_k
            slots.append(slot)
        n = len(group)
        lens_true = [len(c) for c in ctxs]
        maxlen = max(lens_true)
        Bb = self.max_batch if self._pad_prefill else n
        # pad rows: len 1, slot ``max_batch`` (dropped before any write)
        lens = np.ones(Bb, np.int32)
        slot_arr = np.full(Bb, self.max_batch, np.int32)
        for i in range(n):
            lens[i] = lens_true[i]
            slot_arr[i] = slots[i]
        if self._packed:
            starts_np = np.zeros(Bb, np.int32)
            last_idx = np.zeros(Bb, np.int32)
            off = 0
            for i in range(n):
                starts_np[i] = off
                off += lens_true[i]
                last_idx[i] = off - 1
            # exact length: eager execution has no compile count to bound,
            # so the reference's pow2 round-up of T would only add work;
            # but a MoE stack takes the reference's shape (``_call_len``)
            T = self._call_len(off)
            toks = np.zeros((1, T), np.int64)
            pos = np.zeros((1, T), np.int32)
            seg = np.full((1, T), -1, np.int32)
            for i, ctx in enumerate(ctxs):
                s, L = starts_np[i], lens_true[i]
                toks[0, s:s + L] = ctx
                pos[0, s:s + L] = np.arange(L)
                seg[0, s:s + L] = i
            self._prefill_shapes.add((1, T))
            last_logits, pf_caches = self._prefill_packed(toks, pos, seg,
                                                          last_idx)
            self._seed_packed(pf_caches, slot_arr, starts_np, lens)
        else:
            Sb = maxlen
            if self._pad_prefill:
                # pow2 bucket, clamped to capacity
                Sb = seq_bucket(maxlen)
                if Sb > self.capacity:
                    Sb = max(maxlen, self.capacity)
            toks = np.zeros((Bb, Sb), np.int64)
            for i, ctx in enumerate(ctxs):
                toks[i, :len(ctx)] = ctx
            self._prefill_shapes.add((Bb, Sb))
            last_logits, pf_caches = self._prefill(toks, lens)
            self._seed(pf_caches, slot_arr, lens)
        temps = np.zeros(Bb, np.float32)
        top_ks = np.zeros(Bb, np.int32)
        eos = np.full(Bb, -1, np.int32)
        for i, (r, _) in enumerate(group):
            g = self.requests[r.rid]
            temps[i] = g.params.temperature
            top_ks[i] = g.params.top_k
            eos[i] = -1 if g.params.eos_token is None else g.params.eos_token
        first = sample_per_request(last_logits, self.gen, temps, top_ks)
        if self._async:
            # the first token stays on the device: it goes into the slot
            # state and drains with the regular lag-N ring
            fallback = np.zeros(Bb, np.int32)
            use_first = np.zeros(Bb, bool)
            mapping: List[Tuple[int, int]] = []
            for i, (r, _) in enumerate(group):
                g = self.requests[r.rid]
                self.pos[slots[i]] = lens[i]
                if r.generated == 0:
                    # the PT iteration produces the first response token
                    use_first[i] = True
                    mapping.append((i, r.rid))
                else:
                    fallback[i] = g.output[r.generated - 1]
            self._seed_slots(slot_arr, first, fallback, use_first, lens,
                             temps, top_ks, eos)
            self._enqueue_first(first, mapping)
        else:
            first_np = first.cpu().numpy()
            for i, (r, _) in enumerate(group):
                g = self.requests[r.rid]
                slot = slots[i]
                self.pos[slot] = lens[i]
                if r.generated == 0:
                    tok = int(first_np[i])
                    g.output.append(tok)
                    g.t_first_sampled = g.t_first_drained = time.monotonic()
                    self.last_tok[slot] = tok
                else:
                    self.last_tok[slot] = g.output[r.generated - 1]

    # ------------------------------------------------------------------ #
    def _run_chunk_items(self, items, now: float) -> None:
        """Execute partial-prompt (chunked) PT grants: a wave of >= 2 as
        one packed call, otherwise one call per chunk, attending over the
        request's seeded cache prefix (pure attention), resuming its
        carried recurrent-state snapshot (pure-recurrent stacks), or
        recomputing the whole prefix (the reference path). Only the chunk
        that completes the prompt samples the first response token."""
        infos = []
        for r, chunk in items:
            g = self.requests[r.rid]
            # prompt + the generated tail minus the newest token (see
            # _prefill_group); the tail rides the chunk completing the prompt
            ctx = list(g.prompt) + g.output[:max(0, r.generated - 1)]
            start = self._chunk_progress.get(r.rid, 0)
            completing = r.prompt_done + chunk >= r.prompt_len
            end = len(ctx) if completing else start + chunk
            assert end <= self.capacity, "chunk exceeds cache capacity"
            if r.rid not in self.slot_of:
                slot = self.free_slots.pop()
                self.slot_of[r.rid] = slot
                self.temps[slot] = g.params.temperature
                self.top_ks[slot] = g.params.top_k
            slot = self.slot_of[r.rid]
            self.n_prefill_chunks += 1
            infos.append((r, ctx, start, end, slot, completing))
        if self._chunk_packed and len(infos) >= 2:
            lasts = self._exec_chunks_packed(infos)
        else:
            lasts = []
            for r, ctx, start, end, slot, completing in infos:
                self.n_chunk_calls += 1
                self.max_chunk_items_per_call = max(
                    self.max_chunk_items_per_call, 1)
                if self._chunk_incremental:
                    lasts.append(self._exec_chunk_incremental(
                        ctx, start, end, slot))
                elif self._chunk_rec:
                    lasts.append(self._exec_chunk_state(ctx, start, end,
                                                        r.rid))
                else:
                    lasts.append(self._exec_chunk_recompute(ctx, end, slot))
        finals = []
        for (r, ctx, start, end, slot, completing), last in zip(infos,
                                                                lasts):
            self._chunk_progress[r.rid] = end
            if completing:
                del self._chunk_progress[r.rid]
                if self._chunk_rec:
                    # the carried snapshot becomes the decode-cache row
                    self._seed(self._rec_state.pop(r.rid), [slot], [end])
                finals.append((r, slot, last, end))
        if not finals:
            return
        n = len(finals)
        temps = np.zeros(n, np.float32)
        top_ks = np.zeros(n, np.int32)
        eos = np.full(n, -1, np.int32)
        lens = np.zeros(n, np.int32)
        slot_arr = np.zeros(n, np.int32)
        for i, (r, slot, _, end) in enumerate(finals):
            g = self.requests[r.rid]
            temps[i] = g.params.temperature
            top_ks[i] = g.params.top_k
            eos[i] = -1 if g.params.eos_token is None else g.params.eos_token
            lens[i] = end
            slot_arr[i] = slot
        first = sample_per_request(torch.stack([f[2] for f in finals]),
                                   self.gen, temps, top_ks)
        if self._async:
            fallback = np.zeros(n, np.int32)
            use_first = np.zeros(n, bool)
            mapping: List[Tuple[int, int]] = []
            for i, (r, slot, _, end) in enumerate(finals):
                self.pos[slot] = end
                if r.generated == 0:
                    use_first[i] = True
                    mapping.append((i, r.rid))
                else:
                    fallback[i] = self.requests[r.rid].output[r.generated - 1]
            self._seed_slots(slot_arr, first, fallback, use_first, lens,
                             temps, top_ks, eos)
            self._enqueue_first(first, mapping)
        else:
            first_np = first.cpu().numpy()
            for i, (r, slot, _, end) in enumerate(finals):
                g = self.requests[r.rid]
                self.pos[slot] = end
                if r.generated == 0:
                    tok = int(first_np[i])
                    g.output.append(tok)
                    g.t_first_sampled = g.t_first_drained = time.monotonic()
                    self.last_tok[slot] = tok
                else:
                    self.last_tok[slot] = g.output[r.generated - 1]

    def _exec_chunks_packed(self, infos):
        """All of an iteration's chunk grants in ONE prefill call: the
        packed token axis concatenates every chunk with per-segment
        absolute positions and segment ids; the key axis prepends each
        segment's cache-prefix view with per-slot positions (POS_INVALID
        beyond the seeded prefix). Returns per-segment last-token logits."""
        n = len(infos)
        starts = [i[2] for i in infos]
        lens = [i[3] - i[2] for i in infos]
        pos, seg, ppos, pseg, offs = packed_chunk_layout(starts, lens,
                                                         self.capacity)
        toks = np.concatenate([ctx[start:end] for _, ctx, start, end, _, _
                               in infos]).astype(np.int64)[None]
        pad = self._call_len(toks.shape[1]) - toks.shape[1]
        if pad:                      # pad tokens: token 0, pos 0, seg -1
            toks, pos = (np.pad(a, ((0, 0), (0, pad))) for a in (toks, pos))
            seg = np.pad(seg, ((0, 0), (0, pad)), constant_values=-1)
        last_idx = (offs + np.asarray(lens) - 1).astype(np.int32)
        slots = [i[4] for i in infos]
        self._prefill_shapes.add(toks.shape)
        self.n_chunk_calls += 1
        self.max_chunk_items_per_call = max(self.max_chunk_items_per_call,
                                            n)
        last = self._chunks_packed(toks, pos, seg, ppos, pseg, slots,
                                   last_idx, starts, lens, offs)
        return [last[i] for i in range(n)]

    def _exec_chunk_incremental(self, ctx, start: int, end: int,
                                slot: int):
        """Run ctx[start:end) as a prefix-attending chunk and seed its K/V
        into the slot's cache row (exact length: no pow2 round-up, but for
        a MoE stack; its pad tokens continue the positions)."""
        L = end - start
        Sb = self._call_len(L, self.capacity - start)
        toks = np.zeros((1, Sb), np.int64)
        toks[0, :L] = ctx[start:end]
        pos = (start + np.arange(Sb, dtype=np.int32))[None]
        self._prefill_shapes.add((1, Sb))
        return self._chunk_prefill(toks, pos, slot, start, L)

    def _exec_chunk_state(self, ctx, start: int, end: int, rid: int):
        """Chunk prefill for pure-recurrent stacks: resume from the carried
        per-request state snapshot (O(n) in all, against the recompute
        path's O(n^2)); the snapshot seeds the decode-cache row when the
        prompt completes. Exact shapes; a first chunk (no snapshot yet)
        starts from the zero state."""
        L = end - start
        toks = np.asarray([ctx[start:end]], np.int64)
        self._prefill_shapes.add((1, L))
        x, self._rec_state[rid] = model.prefill_hidden(
            self.cfg, self.params, self._t(toks, torch.long),
            prefix_caches=self._rec_state.pop(rid, None))
        return model.logits_fn(self.cfg, self.params, x[0, L - 1])

    def _exec_chunk_recompute(self, ctx, end: int, slot: int):
        """Chunk fallback with no resumable prefix (hybrid stacks, ring
        caches, or ``incremental_chunk_prefill=False``): re-run positions
        [0, end) and reseed the whole cache row. Exact length for every
        stack but MoE (the reference pads attention-pure ones to a pow2
        bucket only to bound XLA's compiles)."""
        toks = np.zeros((1, self._call_len(end, self.capacity)), np.int64)
        toks[0, :end] = ctx[:end]
        self._prefill_shapes.add(toks.shape)
        last, pf_caches = self._prefill(toks, [end])
        self._seed(pf_caches, [slot], [end])
        return last[0]

    # ------------------------------------------------------------------ #
    def _run_decode(self, reqs: Sequence[Request], now: float) -> None:
        """Legacy sync decode: one host sync per iteration for the sampled
        batch — the reference the async path is held against."""
        if not reqs:
            return
        active = np.zeros(self.max_batch, bool)
        for r in reqs:
            active[self.slot_of[r.rid]] = True
        toks = self._t(self.last_tok, torch.long)[:, None]
        pos = self._t(self.pos, torch.int32)
        logits, _ = model.decode_step(self.cfg, self.params, toks, pos,
                                      self.caches, active=self._t(active))
        # inactive slots are sampled greedily and never read back
        temps = np.where(active, self.temps, 0.0).astype(np.float32)
        top_ks = np.where(active, self.top_ks, 0).astype(np.int32)
        self.sync_counts["drain_blocking"] += 1
        new_toks = sample_per_request(logits, self.gen, temps,
                                      top_ks).cpu().numpy()
        self.decode_iters += 1
        self.n_decode_dispatches += 1
        for r in reqs:
            slot = self.slot_of[r.rid]
            g = self.requests[r.rid]
            tok = int(new_toks[slot])
            g.output.append(tok)
            self.pos[slot] += 1
            self.last_tok[slot] = tok
            if g.params.eos_token is not None and tok == g.params.eos_token:
                self.scheduler.notify_eos(r, r.generated + 1)

    def _run_decode_async(self, plan, now: float) -> None:
        """Device-resident decode: the host builds the (B,) active mask and
        dispatches; sampled tokens land in the lag-N ring. EOS flags are
        read back only when an active request has an ``eos_token``. When
        the scheduler proves a K-iteration horizon, K iterations run as one
        megastep window and the next K-1 calls replay it on the host."""
        reqs = plan.decode_reqs
        if not reqs:
            return
        self._drain_tokens()
        if self._mega_left > 0:
            self._consume_mega_row(reqs)
            return
        active = np.zeros(self.max_batch, bool)
        eos_possible = False
        for r in reqs:
            active[self.slot_of[r.rid]] = True
            if self.requests[r.rid].params.eos_token is not None:
                eos_possible = True
        temps_m = np.where(active, self.temps, 0.0)
        need_sample = bool(np.any(temps_m > 0.0))
        need_topk = need_sample and bool(
            np.any(np.where(active, self.top_ks, 0) > 0))
        # the active mask only changes on admission/completion/preemption
        ab = active.tobytes()
        if ab != self._active_bytes:
            self._active_bytes = ab
            self._dev["active"].copy_(torch.from_numpy(active))
        K = self.scheduler.decode_horizon(plan, self._mega_max)
        if K > 1:
            sched = self.scheduler
            stop_on_eos = eos_possible and bool(sched.pt_queue
                                                or sched.gt_queue)
            with span("engine.decode_launch", self.spans):
                self._mega_toks, eos_buf, gen_states = self._mega_fn(
                    self._dev["active"], K, need_sample, need_topk,
                    stop_on_eos)
            self.n_decode_dispatches += 1
            self.n_mega_windows += 1
            if eos_possible:
                # one blocking readback per window
                self.sync_counts["eos_flags"] += 1
                with span("engine.eos_readback", self.spans):
                    self._mega_eos = eos_buf.cpu().numpy()
                if stop_on_eos:
                    slots = [self.slot_of[r.rid] for r in reqs]
                    hit = self._mega_eos[:K, slots].any(axis=1)
                    if hit.any():
                        K = int(hit.argmax()) + 1
                if gen_states is not None:
                    self._rewind_gen(gen_states, self._mega_eos[:K],
                                     temps_m)
            else:
                self._mega_eos = None
            self._mega_row = -1
            self._mega_left = K
            self._consume_mega_row(reqs)
            return
        with span("engine.decode_launch", self.spans):
            toks, eos_hit = self._one_iter(self._dev["active"], need_sample,
                                           need_topk)
            if self._graphed:
                toks = toks.clone()     # the ring outlives the graph output
        self.n_decode_dispatches += 1
        self.decode_iters += 1
        self.n_graphed_decode_iters += self._graphed
        self._enqueue_drain(
            toks, None, [(self.slot_of[r.rid], r.rid) for r in reqs])
        if eos_possible:
            self.sync_counts["eos_flags"] += 1
            with span("engine.eos_readback", self.spans):
                flags = eos_hit.cpu().numpy()
            for r in reqs:
                if flags[self.slot_of[r.rid]]:
                    self.scheduler.notify_eos(r, r.generated + 1)

    def _rewind_gen(self, gen_states, eos: np.ndarray,
                    temps: np.ndarray) -> None:
        """Leave the generator where the K=1 path leaves it after the
        window's K executed iterations (``eos`` (K, B), the window's flags
        up to its cut): that path draws while a sampling row is live, and a
        row leaves after the iteration in which it sampled its EOS. So it
        draws in the first n iterations, n the latest such exit among the
        sampling rows (K for a row that does not exit), and the generator
        takes the state after the window's n-th draw."""
        hit = eos[:, temps > 0.0]
        n = int(np.where(hit.any(axis=0), hit.argmax(axis=0) + 1,
                         len(eos)).max())
        self.gen.set_state(gen_states[n - 1])

    def _consume_mega_row(self, reqs: Sequence[Request]) -> None:
        """One host-replay iteration of a megastep window."""
        with span("engine.mega_replay", self.spans):
            self._mega_row += 1
            self._mega_left -= 1
            i = self._mega_row
            self.decode_iters += 1
            self.n_graphed_decode_iters += self._graphed
            self._enqueue_drain(
                self._mega_toks, i,
                [(self.slot_of[r.rid], r.rid) for r in reqs],
                new_dispatch=(i == 0))
            if self._mega_eos is not None:
                flags = self._mega_eos[i]
                for r in reqs:
                    if flags[self.slot_of[r.rid]]:
                        self.scheduler.notify_eos(r, r.generated + 1)

    def _enqueue_drain(self, toks, row, mapping,
                       new_dispatch: bool = True) -> None:
        """Push one sampled-token entry into the readback ring and classify
        it now, from the dispatch sequence alone (as the reference)."""
        if new_dispatch:
            self._drain_seq += 1
            self._last_event = self._record_event()
        seq = self._drain_seq
        if any(s != seq for s in self._recent_drain_seqs):
            self.sync_counts["drain_backpressure"] += 1
        else:
            self.sync_counts["drain_ready"] += 1
        self._recent_drain_seqs.append(seq)
        self._pending_drain.append((toks, row, mapping, self._last_event))

    def _enqueue_first(self, first: torch.Tensor,
                       mapping: List[Tuple[int, int]]) -> None:
        """Push a prefill's first response tokens into the readback ring,
        stamping each request's ``t_first_sampled``."""
        if not mapping:
            return
        self._enqueue_drain(first, None, mapping)
        t = time.monotonic()
        for _, rid in mapping:
            self.requests[rid].t_first_sampled = t

    def _drain_tokens(self, force: bool = False) -> None:
        """Materialize pending sampled-token batches older than the lag,
        all through one device-to-host copy. Readiness (the entry's event)
        only steers the pop policy; accounting happened at enqueue. A
        request's first token stamps its ``t_first_drained``."""
        with span("engine.drain", self.spans):
            dq = self._pending_drain
            lag = 0 if force else self.ecfg.readback_lag
            batch = []
            while len(dq) > lag:
                toks, row, mapping, ev = dq[0]
                ready = ev is None or ev.query()
                if not ready and not force and len(
                        {id(t) for t, _, _, _ in dq}) <= self.ecfg.max_pending:
                    break
                dq.popleft()
                batch.append((toks, row, mapping))
            if not batch:
                return
            uniq: Dict[int, torch.Tensor] = {}
            for toks, _, _ in batch:
                uniq.setdefault(id(toks), toks)
            flat = torch.cat([t.reshape(-1) for t in uniq.values()]).cpu()
            t_host = time.monotonic()
            mat_of, off = {}, 0
            for key, t in uniq.items():
                mat_of[key] = flat[off:off + t.numel()].reshape(
                    t.shape).numpy()
                off += t.numel()
            for toks, row, mapping in batch:
                arr = mat_of[id(toks)]
                if row is not None:
                    arr = arr[row]
                for r_, rid in mapping:
                    g = self.requests[rid]
                    if not g.output:
                        g.t_first_drained = t_host
                    g.output.append(int(arr[r_]))
                self.n_tokens_drained += len(mapping)

    # ------------------------------------------------------------------ #
    def step(self, now: Optional[float] = None) -> int:
        """One engine iteration. Returns number of completions."""
        now = time.monotonic() if now is None else now
        set_current(self.spans)
        if self._mega_left == 0 and (self._arrivals or self._pending_injects
                                     or self._pending_aborts):
            # a window just drained: apply the aborts it deferred, then
            # deliver arrivals
            with span("engine.admit", self.spans):
                for rid, t_ab, reason in self._pending_aborts:
                    self._apply_abort(rid, t_ab, reason)
                self._pending_aborts.clear()
                for payload, t_in in self._pending_injects:
                    self._apply_inject(payload, t_in)
                self._pending_injects.clear()
                for r, t_arr in self._arrivals:
                    self.scheduler.on_arrival(r, t_arr)
                self._arrivals.clear()
        if self._mega_left == 0 and self._pending_squeeze:
            kvc = self.scheduler.kvc
            kvc.shrink(int(kvc.capacity_tokens * self._pending_squeeze))
            self._pending_squeeze = 0.0
        if self.guard is not None and self._mega_left == 0:
            self._guard_step(now)
        with span("scheduler.form_batch", self.spans):
            plan = self.scheduler.form_batch(now)
        if self.scheduler.infeasible_shed:
            # rung 4: requests a squeeze made permanently inadmissible
            shed, self.scheduler.infeasible_shed = \
                self.scheduler.infeasible_shed, []
            for r in shed:
                self.abort(r.rid, now, "kvc-infeasible")
                g = self.requests.get(r.rid)
                if g is not None and g.status == "aborted":
                    if self.fleet_shed_handback:
                        g.status = None
                        g.fail_reason = None
                        self.n_aborted -= 1
                        self.requests.pop(r.rid, None)
                        self.shed_handback.append(g)
                    else:
                        g.status = "shed"
                        self.n_aborted -= 1
                        self.n_shed += 1
        if plan.empty:
            if self._mega_left:
                # every window request completed early (EOS in the window)
                self._mega_left = 0
                self._mega_toks = self._mega_eos = None
            if self._pending_drain:
                self.sync_counts["flush"] += 1
                self._drain_tokens(force=True)
            if self.metrics is not None:
                self.metrics.on_step(self, now)
            return 0
        # GTs rescheduled after a swap-style preemption arrive without a
        # slot: restored from the host pool (rung 2) or recomputed with the
        # iteration's prefill wave (rung 3)
        missing = [r for r in plan.decode_reqs if r.rid not in self.slot_of]
        if self._mega_left > 0:
            assert not plan.prompt_items and not missing, \
                "megastep horizon violated: admission inside a fused window"
        if missing and self._pending_drain:     # ctx rebuild reads g.output
            self.sync_counts["flush"] += 1
            self._drain_tokens(force=True)
        if missing:
            missing = self._swap_in(missing, now)
        self._run_prefill(plan.prompt_items, now, missing=missing)
        with span("engine.decode", self.spans):
            if self._async:
                self._run_decode_async(plan, now)
            else:
                self._run_decode(plan.decode_reqs, now)
        with span("scheduler.finish_iteration", self.spans):
            before = len(self.scheduler.completed)
            self.scheduler.finish_iteration(now)
            done = self.scheduler.completed[before:]
            freed = False
            for r in done:
                g = self.requests[r.rid]
                if g.finished:
                    self.n_dup_completions += 1     # first writer wins
                else:
                    g.t_done = r.t_complete
                    g.status = "completed"
                slot = self.slot_of.pop(r.rid, None)
                if slot is not None:
                    self.free_slots.append(slot)
                    freed = True
        # preempted/evicted requests (KVC freed by the scheduler) lose
        # their slot after their pages are offloaded (rung 2); queued GTs
        # keep theirs
        for rid in list(self.slot_of):
            if rid not in self.scheduler.kvc.allocs:
                slot = self.slot_of.pop(rid)
                self.free_slots.append(slot)
                self._chunk_progress.pop(rid, None)
                self._rec_state.pop(rid, None)
                self._swap_out(rid, slot)
                freed = True
        if freed and self._pending_drain:
            # completed outputs must be materialized before t_done is
            # observable; a preempted request rebuilds its context from
            # g.output at the next prefill
            self.sync_counts["flush"] += 1
            self._drain_tokens(force=True)
        if self.metrics is not None:
            self.metrics.on_step(self, now)
        return len(done)

    def flush(self) -> None:
        """Force-drain the token readback ring."""
        if self._pending_drain:
            self.sync_counts["flush"] += 1
            self._drain_tokens(force=True)

    # ------------------------------------------------------------------ #
    # liveness / diagnostics
    # ------------------------------------------------------------------ #
    def progress_state(self) -> tuple:
        """Monotone fingerprint of forward progress (``serve_stream``
        raises ``FleetStalled`` when it freezes while work remains)."""
        return (self.decode_iters, self.n_prefill_waves,
                self.n_prefill_chunks, len(self.scheduler.completed),
                self.n_aborted, self.n_kv_injects, self._rid)

    def publish_metrics(self, registry, instance: str = "0") -> None:
        """Publish every engine/scheduler/KVC counter and gauge into a
        ``repro_torch.obs`` registry (host values only)."""
        publish_engine(self, registry, instance)

    def debug_state(self) -> Dict[str, object]:
        """Queue/KVC snapshot for stall diagnostics, read back from a
        registry snapshot: the publication path live metrics use."""
        reg = MetricsRegistry()
        self.publish_metrics(reg)
        return reg.snapshot().flat()

    def run(self, gen_requests: Sequence[GenRequest],
            arrivals: Optional[Sequence[float]] = None,
            max_steps: int = 100_000, stall_limit: int = 2_000
            ) -> List[GenRequest]:
        """Serve a batch to completion, or an online stream with
        ``arrivals`` on the engine's iteration clock."""
        return serve_stream(self, gen_requests, arrivals, max_steps,
                            stall_limit)


def serve_stream(server, gen_requests: Sequence[GenRequest],
                 arrivals: Optional[Sequence[float]] = None,
                 max_steps: int = 100_000,
                 stall_limit: int = 2_000) -> List[GenRequest]:
    """Drive any submit/step/has_work/flush server over an online request
    stream on its iteration clock: submit each request at its arrival
    time, step while there is work, jump the clock across idle gaps, flush
    the readback ring at the end. A ``RequestShed`` from ``submit`` is
    caught (the terminal state is recorded); ``stall_limit`` consecutive
    steps without progress raise ``FleetStalled``."""
    if arrivals is None:
        arrivals = [0.0] * len(gen_requests)
    stream = sorted(zip(gen_requests, arrivals), key=lambda p: p[1])
    fingerprint = getattr(server, "progress_state", None)
    t, i, steps, stalled, last_fp = 0.0, 0, 0, 0, None
    while steps < max_steps:
        submitted = False
        while i < len(stream) and stream[i][1] <= t:
            try:
                server.submit(stream[i][0], float(stream[i][1]))
            except RequestShed:
                pass              # typed fast-fail; terminal state recorded
            i += 1
            submitted = True
        if not server.has_work():
            if i >= len(stream):
                break
            t = max(t, float(stream[i][1]))
            continue
        t += 1.0
        server.step(t)
        steps += 1
        if fingerprint is not None:
            fp = fingerprint()
            if fp == last_fp and not submitted:
                stalled += 1
                if stalled >= stall_limit:
                    dbg = getattr(server, "debug_state", dict)()
                    raise FleetStalled(
                        f"no progress for {stall_limit} consecutive steps "
                        f"with work outstanding (t={t}); per-instance "
                        f"state: {dbg}", debug=dbg)
            else:
                stalled = 0
            last_fp = fp
    server.flush()
    return list(gen_requests)
