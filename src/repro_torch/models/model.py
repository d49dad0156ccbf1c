"""Model assembly for pattern-driven block stacks, mirroring
``repro.models.model``: attention (``A``), Mamba2 (``M``), mLSTM (``X``)
and sLSTM (``S``) blocks in any order, and a Zamba2-style shared attention
block applied after every ``shared_attention_every`` layers (one set of
weights for every invocation). An attention block's feed-forward is a
dense SwiGLU, a top-k MoE (``moe.py``), or both summed (Arctic's dense
residual). Prefill takes precomputed frontend embeddings (vision patches,
audio frames) ahead of the tokens. Parameters, caches, prefill, decode and
logits.

Parameters live in a flat dict ``{name: tensor}``. The weights of the
layers of one kind are stacked along a leading axis (n, ...), n the layers
of that kind; the shared block is not stacked. Attention names carry no
prefix (``wq``, ``attn_norm``, ...; a MoE's under ``moe.``), the other
kinds theirs (``mamba.``, ``mlstm.``, ``slstm.``, ``shared.``). The forward
passes are a Python loop over the pattern where the reference scans
segments, each layer's weights a view into the stacked tensor. Caches are
``{kind: {leaf: tensor}}`` with leaves (n, B, ...) as the reference's
``init_cache``: K/V (n, B, C, K, hd) for ``A`` and ``"shared"``, the
recurrent states for the other kinds. ``forward_train`` is the training
forward: logits over the whole sequence and the MoE aux loss, each layer
rematerialised under ``cfg.remat``, with no cache and no kernel.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..distributed.dtensor import (gather_fsdp, is_dtensor, pad_rows, psum,
                                   rows_heads, unpad_rows)
from . import attention, mlp, moe, ssm, xlstm
from .common import (BATCH_AXES, EMBED, LAYER, VOCAB, ParamMeta, ParamTree,
                     abstract_params, init_params, maybe_constrain, rms_norm)
from .config import ATTN, MAMBA, MLSTM, SLSTM, ModelConfig

Params = Dict[str, torch.Tensor]
Cache = Dict[str, Dict[str, torch.Tensor]]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# per-layer parameter names of an ATTN block (and of the shared block):
# attention weights from ``attention.attn_params``, MLP weights from
# ``mlp.mlp_params``, MoE weights from ``moe.moe_params`` under ``MOE``
ATTN_NORM, MLP_NORM = "attn_norm", "mlp_norm"
MOE = "moe."
PREFIX = {ATTN: "", MAMBA: "mamba.", MLSTM: "mlstm.", SLSTM: "slstm."}
SHARED = "shared"
KV_KINDS = (ATTN, SHARED)
RECURRENT_PREFILL = {MAMBA: ssm.ssm_prefill, MLSTM: xlstm.mlstm_prefill,
                     SLSTM: xlstm.slstm_prefill}
RECURRENT_DECODE = {MAMBA: ssm.ssm_decode, MLSTM: xlstm.mlstm_decode,
                    SLSTM: xlstm.slstm_decode}


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def kind_counts(cfg: ModelConfig) -> Dict[str, int]:
    c: Dict[str, int] = {}
    for ch in cfg.pattern():
        c[ch] = c.get(ch, 0) + 1
    return c


def segments(cfg: ModelConfig):
    """Contiguous same-kind runs of the pattern: (kind, offset_in_kind,
    len), ``offset_in_kind`` indexing the stacked params of that kind."""
    segs, counts, pat, i = [], {}, cfg.pattern(), 0
    while i < len(pat):
        j = i
        while j < len(pat) and pat[j] == pat[i]:
            j += 1
        segs.append((pat[i], counts.get(pat[i], 0), j - i))
        counts[pat[i]] = counts.get(pat[i], 0) + (j - i)
        i = j
    return segs


def num_shared_invocations(cfg: ModelConfig) -> int:
    if not cfg.shared_attention_every:
        return 0
    return cfg.num_layers // cfg.shared_attention_every


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.with_(num_kv_heads=cfg.shared_attn_kv_heads) \
        if cfg.shared_attn_kv_heads else cfg


def _shared_after(cfg: ModelConfig, layer: int, done: int) -> bool:
    """Whether a shared-block invocation follows pattern layer ``layer``
    (0-based) when ``done`` invocations have run."""
    every = cfg.shared_attention_every
    return bool(every) and (layer + 1) % every == 0 \
        and done < num_shared_invocations(cfg)


def _walk(cfg: ModelConfig, params: Params):
    """The stack in pattern order, shared by prefill, decode and training:
    (kind, index within its kind, the layer's weights, the index of the
    shared-block invocation that follows the layer, or None)."""
    done: Dict[str, int] = {}
    n_shared = 0
    for layer, kind in enumerate(cfg.pattern()):
        i = done.get(kind, 0)
        done[kind] = i + 1
        inv = None
        if _shared_after(cfg, layer, n_shared):
            inv, n_shared = n_shared, n_shared + 1
        yield kind, i, layer_params(params, cfg, kind, i), inv


# --------------------------------------------------------------------------- #
# parameters and caches
# --------------------------------------------------------------------------- #
def _attn_block_tree(cfg: ModelConfig) -> ParamTree:
    d = cfg.d_model
    t: ParamTree = {ATTN_NORM: ParamMeta((d,), (EMBED,), init="ones")}
    t.update(attention.attn_params(cfg))
    t[MLP_NORM] = ParamMeta((d,), (EMBED,), init="ones")
    if cfg.is_moe:
        t.update({MOE + k: m for k, m in moe.moe_params(cfg).items()})
    if not cfg.is_moe or cfg.moe_dense_residual:
        t.update(mlp.mlp_params(cfg))
    return t


def _block_tree(cfg: ModelConfig, kind: str) -> ParamTree:
    """Per-layer (unstacked) parameters of one block kind, unprefixed."""
    if kind == ATTN:
        return _attn_block_tree(cfg)
    cell = {MAMBA: ssm.ssm_params, MLSTM: xlstm.mlstm_params,
            SLSTM: xlstm.slstm_params}[kind](cfg)
    return {"norm": ParamMeta((cfg.d_model,), (EMBED,), init="ones"),
            **cell}


def param_tree(cfg: ModelConfig) -> ParamTree:
    d, v = cfg.d_model, cfg.vocab_size
    t: ParamTree = {"tok_embed": ParamMeta((v, d), (VOCAB, EMBED))}
    for kind, n in kind_counts(cfg).items():
        for k, m in _block_tree(cfg, kind).items():
            t[PREFIX[kind] + k] = ParamMeta((n,) + m.shape,
                                            (LAYER,) + m.axes, init=m.init,
                                            scale=m.scale)
    if num_shared_invocations(cfg):
        for k, m in _attn_block_tree(_shared_cfg(cfg)).items():
            t[f"{SHARED}.{k}"] = m
    t["final_norm"] = ParamMeta((d,), (EMBED,), init="ones")
    if not cfg.tie_embeddings:
        t["head"] = ParamMeta((d, v), (EMBED, VOCAB))
    return t


def init(cfg: ModelConfig, gen: torch.Generator, device=None) -> Params:
    """Seeded random weights (``scale/sqrt(fan_in)``, ones for norms)."""
    device = torch.device(device) if device is not None else gen.device
    return init_params(param_tree(cfg), gen, dtype_of(cfg.param_dtype),
                       device)


def abstract(cfg: ModelConfig) -> Params:
    """The parameters as ``meta`` tensors of the param dtype."""
    return abstract_params(param_tree(cfg), dtype_of(cfg.param_dtype))


@functools.lru_cache(maxsize=None)
def _names(cfg: ModelConfig, kind: str) -> Tuple[str, ...]:
    if kind == SHARED:
        return tuple(_attn_block_tree(_shared_cfg(cfg)))
    return tuple(_block_tree(cfg, kind))


def layer_params(params: Params, cfg: ModelConfig, kind: str,
                 index: int) -> Params:
    """Views of the weights of the ``index``-th layer of ``kind``, under
    their unprefixed names."""
    pre = PREFIX[kind]
    return {k: params[pre + k][index] for k in _names(cfg, kind)}


def shared_params(params: Params, cfg: ModelConfig) -> Params:
    """The shared block's weights under their unprefixed names."""
    return {k: params[f"{SHARED}.{k}"] for k in _names(cfg, SHARED)}


def _stack(one: Dict[str, torch.Tensor], n: int) -> Dict[str, torch.Tensor]:
    return {k: a[None].expand(n, *a.shape).clone() for k, a in one.items()}


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=None,
               device=None) -> Cache:
    """Decode caches at a context capacity (window-clamped for ``A``)."""
    dtype = dtype or dtype_of(cfg.dtype)
    kc = kind_counts(cfg)
    hd = cfg.resolved_head_dim
    caches: Cache = {}
    if ATTN in kc:
        C = min(capacity, cfg.sliding_window) if cfg.sliding_window \
            else capacity
        shape = (kc[ATTN], batch, C, cfg.num_kv_heads, hd)
        caches[ATTN] = {n: torch.zeros(shape, dtype=dtype, device=device)
                        for n in ("k", "v")}
    if MAMBA in kc:
        caches[MAMBA] = _stack(ssm.ssm_init_cache(cfg, batch, dtype, device),
                               kc[MAMBA])
    if MLSTM in kc:
        caches[MLSTM] = _stack(xlstm.mlstm_init_cache(cfg, batch, device),
                               kc[MLSTM])
    if SLSTM in kc:
        caches[SLSTM] = _stack(xlstm.slstm_init_cache(cfg, batch, device),
                               kc[SLSTM])
    n_inv = num_shared_invocations(cfg)
    if n_inv:
        shape = (n_inv, batch, capacity, _shared_cfg(cfg).num_kv_heads, hd)
        caches[SHARED] = {n: torch.zeros(shape, dtype=dtype, device=device)
                          for n in ("k", "v")}
    return caches


def seed_cache(cfg: ModelConfig, cache: Cache, prefill_caches: Cache,
               prompt_len: int) -> Cache:
    """Copy prefill outputs into a decode cache of larger capacity, in
    place: K/V token p at slot p (the last C tokens at ring slots p % C
    when the prompt is longer than a windowed cache); recurrent states as
    they are."""
    for kind, sub in cache.items():
        if kind not in prefill_caches:
            continue
        for n, dst in sub.items():
            src = prefill_caches[kind][n]
            if kind not in KV_KINDS:
                dst.copy_(src)
                continue
            C, S = dst.shape[2], src.shape[2]
            if S <= C:
                dst[:, :, :S] = src.to(dst.dtype)
            else:
                dst.copy_(torch.roll(src[:, :, S - C:], shifts=(S - C) % C,
                                     dims=2))
    return cache


# --------------------------------------------------------------------------- #
# forward passes
# --------------------------------------------------------------------------- #
def _embed_sharded(table, tokens):
    """The lookup of a DTensor table (V, d), vocab-parallel as Megatron's:
    in a region each ``model`` rank gathers the tokens of its block of rows
    (zero for the others) and the partial rows are summed over ``model``;
    the rows' d is whole, the tokens keep their batch layout.
    Differentiable."""
    mesh = table.device_mesh
    model = mesh.mesh_dim_names.index("model")
    split = table.shape[0] % mesh.size(model) == 0

    def local(t, tok):
        rows = t.shape[0]
        idx = tok.long() - (mesh.get_coordinate()[model] * rows
                            if split else 0)
        mine = (idx >= 0) & (idx < rows)
        x = t[idx.clamp(0, rows - 1)] * mine[..., None].to(t.dtype)
        return psum(x, mesh, model) if split else x

    return rows_heads(local, (table, tokens), ((None, 0), (0, None)),
                      ((0, None),), heads=table.shape[0])


def embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
          embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings, with ``embeds`` (B,F,d) (a frontend's precomputed
    patches or frames, cast to the activation dtype) ahead of them."""
    table = params["tok_embed"]
    x = _embed_sharded(table, tokens) if is_dtensor(table) \
        else table[tokens.long()]
    x = x.to(dtype_of(cfg.dtype))
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return x


def logits_fn(cfg: ModelConfig, params: Params, x: torch.Tensor
              ) -> torch.Tensor:
    head = params["tok_embed"].T if cfg.tie_embeddings else params["head"]
    p = gather_fsdp({"norm": params["final_norm"], "head": head})
    logits = rms_norm(x, p["norm"], cfg.rms_eps) @ p["head"]
    # batch over (pod, data), vocab over model — keeps CE sharded
    return maybe_constrain(logits, BATCH_AXES,
                           *([None] * (logits.dim() - 2)), "model")


def _constrain_acts(x: torch.Tensor) -> torch.Tensor:
    """Residual-stream sharding: batch over (pod,data); sequence over
    "model" (Megatron-style sequence parallelism) — without it the remat-
    saved per-layer activations are replicated across the model axis.
    A no-op without a mesh."""
    seq = "model" if x.shape[1] > 1 else None
    return maybe_constrain(x, BATCH_AXES, seq, None)


def _whole_seq(x: torch.Tensor) -> torch.Tensor:
    """The residual stream with its sequence gathered whole (Megatron's
    all-gather ahead of the tensor-parallel projections). Each projection
    flattens (B, S): over two sharded dims that is a strided shard whose
    offsets DTensor's planner enumerates one symbol an element under
    ``FakeTensorMode``, so the gather comes before it."""
    return maybe_constrain(x, BATCH_AXES, None, None)


def _padded(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """A prefill's or training step's rows (tokens, frontend embeds) with
    a batch that its batch axes do not divide padded to even chunks
    (``dtensor.pad_rows``): every op of the stack then sees an even
    shard, as under GSPMD's padding. ``t`` itself otherwise."""
    return None if t is None else pad_rows(t)


def _unpad_caches(caches: Cache, B: int) -> Cache:
    """A prefill's caches (n, rows, ...) without their pad rows."""
    return {kind: {n: unpad_rows(t, B, 1) for n, t in sub.items()}
            for kind, sub in caches.items()}


def _block_input(x: torch.Tensor, scale: torch.Tensor, cfg: ModelConfig
                 ) -> torch.Tensor:
    """A block's normed input, its sequence whole."""
    return _whole_seq(rms_norm(x, scale, cfg.rms_eps))


def _residual(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + a block's output y in the residual stream's layout. y (often a
    pending sum over "model") is laid out first: DTensor's own choice for
    a sum of a shard and a pending sum is a direct reduce-scatter, whose
    backward older releases refuse."""
    return _constrain_acts(x) + _constrain_acts(y)


def _ffn(p, cfg, h):
    """The feed-forward of an attention block: dense SwiGLU, a MoE, or
    both summed (``moe_dense_residual``). Returns (y, the MoE's aux loss or
    None); serving drops the aux, as the reference's prefill does. Under
    ``torch.profiler`` the MoE shows as the range ``model.moe``."""
    if not cfg.is_moe:
        return mlp.mlp_apply(p, h), None
    with torch.profiler.record_function("model.moe"):
        y, aux = moe.moe_apply({k[len(MOE):]: v for k, v in p.items()
                                if k.startswith(MOE)}, cfg, h)
    if cfg.moe_dense_residual:
        y = y + mlp.mlp_apply(p, h)
    return y, aux


def _attn_block_prefill(p, cfg, x, positions, kv_heads, segment_ids,
                        prefix, prefix_len, prefix_positions,
                        prefix_segment_ids):
    """An attention block (an ``A`` layer or the shared block) over a
    sequence; ``prefix`` is its seeded cache row {k, v} or None. Returns
    (x, {k, v} of the call)."""
    p = gather_fsdp(p, skip=MOE)
    h = _block_input(x, p[ATTN_NORM], cfg)
    y, (k, v) = attention.attn_prefill(
        p, cfg, h, positions, segment_ids=segment_ids, kv_heads=kv_heads,
        prefix_k=None if prefix is None else prefix["k"],
        prefix_v=None if prefix is None else prefix["v"],
        prefix_len=prefix_len, prefix_positions=prefix_positions,
        prefix_segment_ids=prefix_segment_ids)
    x = _residual(x, y)
    y, _ = _ffn(p, cfg, _block_input(x, p[MLP_NORM], cfg))
    return _residual(x, y), {"k": k, "v": v}


def _attn_block_decode(p, cfg, x, pos, ck, cv, kv_heads, active):
    p = gather_fsdp(p, skip=MOE)
    h = rms_norm(x, p[ATTN_NORM], cfg.rms_eps)
    x = _constrain_acts(x + attention.attn_decode(
        p, cfg, h, pos, ck, cv, kv_heads=kv_heads, active=active))
    y, _ = _ffn(p, cfg, rms_norm(x, p[MLP_NORM], cfg.rms_eps))
    return _constrain_acts(x + y)


def _index(sub: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    return {n: a[i] for n, a in sub.items()}


def prefill_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None,
                   segment_ids: Optional[torch.Tensor] = None,
                   prefix_caches: Optional[Cache] = None, prefix_len=None,
                   prefix_positions: Optional[torch.Tensor] = None,
                   prefix_segment_ids: Optional[torch.Tensor] = None,
                   embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """The stack without the final norm and head: (hidden (B,F+S,d),
    caches of this call: each layer's K/V (n,B,F+S,K,hd), or its recurrent
    state at the end of the call). Arguments as ``prefill``."""
    B = tokens.shape[0]
    x, caches = _prefill_stack(cfg, params, tokens, positions, segment_ids,
                               prefix_caches, prefix_len, prefix_positions,
                               prefix_segment_ids, embeds)
    return unpad_rows(x, B), _unpad_caches(caches, B)


def _prefill_stack(cfg, params, tokens, positions, segment_ids,
                   prefix_caches, prefix_len, prefix_positions,
                   prefix_segment_ids, embeds) -> Tuple[torch.Tensor, Cache]:
    """``prefill_hidden`` on rows padded to even chunks under a mesh
    (``_padded``): the hidden states and caches keep the pad rows."""
    kinds = set(cfg.pattern())
    n_inv = num_shared_invocations(cfg)
    if segment_ids is not None:
        assert kinds <= {ATTN} and not n_inv, \
            "token-packed prefill requires a pure-attention stack"
        assert embeds is None, "packed prefill does not take extra embeds"
    if prefix_caches is not None:
        if kinds <= {ATTN} and not n_inv:
            assert positions is not None
            assert (prefix_len is not None) or (
                prefix_positions is not None
                and prefix_segment_ids is not None)
            assert segment_ids is None or prefix_positions is not None, \
                "a packed chunk wave needs per-slot prefix positions"
        else:
            # recurrent state resume: positions are meaningless to the
            # recurrence and attention layers have no snapshot to resume
            assert ATTN not in kinds and not n_inv, \
                "chunk resume needs a pure-attention (kv prefix) or " \
                "pure-recurrent (state snapshot) stack"
            assert segment_ids is None
    x = embed(cfg, params, _padded(tokens), _padded(embeds))
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None]
        # every rank computes RoPE's angles for all rows of ``positions``
        # (a plain tensor): pad rows get one broadcast row rather than
        # twice the rows' angles
        if B == tokens.shape[0]:
            positions = positions.expand(B, S)
    outs: Dict[str, list] = {k: [] for k in cfg.block_kinds()}
    shared = []
    akw = dict(prefix_len=prefix_len, prefix_positions=prefix_positions,
               prefix_segment_ids=prefix_segment_ids)
    for kind, i, p, inv in _walk(cfg, params):
        x = _constrain_acts(x)
        prefix = None if prefix_caches is None \
            else _index(prefix_caches[kind], i)
        if kind == ATTN:
            x, c = _attn_block_prefill(p, cfg, x, positions, None,
                                       segment_ids, prefix, **akw)
        else:
            p = gather_fsdp(p)
            y, c = RECURRENT_PREFILL[kind](
                p, cfg, _block_input(x, p["norm"], cfg), init=prefix)
            x = _residual(x, y)
        outs[kind].append(c)
        if inv is not None:
            scfg = _shared_cfg(cfg)
            sprefix = None if prefix_caches is None \
                else _index(prefix_caches[SHARED], inv)
            x, c = _attn_block_prefill(
                shared_params(params, cfg), scfg, x, positions,
                scfg.num_kv_heads, segment_ids, sprefix, **akw)
            shared.append(c)
    caches = {kind: {n: torch.stack([c[n] for c in lst]) for n in lst[0]}
              for kind, lst in outs.items()}
    if shared:
        caches[SHARED] = {n: torch.stack([c[n] for c in shared])
                          for n in ("k", "v")}
    return _whole_seq(x), caches


def prefill(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None, last_only: bool = False,
            positions: Optional[torch.Tensor] = None,
            segment_ids: Optional[torch.Tensor] = None,
            prefix_caches: Optional[Cache] = None, prefix_len=None,
            prefix_positions: Optional[torch.Tensor] = None,
            prefix_segment_ids: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Returns (logits, caches of the call). ``last_only`` projects only
    the final position.

    ``embeds`` (B,F,d): a frontend's precomputed embeddings, prepended to
    the tokens' (positions 0..F+S-1, logits and caches over all F+S).
    Token-packed prefill (pure attention): ``segment_ids`` (B,S) plus
    ``positions`` that restart at 0 per segment. Chunked prefill over K/V
    (pure attention): ``prefix_caches`` (the request's seeded cache rows,
    (n,B,C,K,hd)) plus scalar ``prefix_len`` and absolute ``positions``;
    the returned caches hold the chunk's K/V only. Packed chunk waves:
    ``segment_ids`` and per-slot ``prefix_positions``/``prefix_segment_ids``
    (B,C) instead. Recurrent chunked prefill (pure SSM/xLSTM stacks):
    ``prefix_caches`` carries the previous chunk's state snapshots (the
    shape this call returns), and the chunk continues the recurrence."""
    B = tokens.shape[0]
    x, caches = _prefill_stack(cfg, params, tokens, positions, segment_ids,
                               prefix_caches, prefix_len, prefix_positions,
                               prefix_segment_ids, embeds)
    logits = logits_fn(cfg, params, x[:, -1] if last_only else x)
    return unpad_rows(logits, B), _unpad_caches(caches, B)


def _write_state(dst: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor],
                 active: Optional[torch.Tensor]) -> None:
    """Write a recurrent layer's new state into its cache views in place;
    with ``active`` (B,) bool, inactive rows keep theirs (a spurious
    h <- f(h, x) advance would corrupt an idle slot's state)."""
    for n, d in dst.items():
        src = new[n].to(d.dtype)
        if active is not None:
            src = torch.where(active.view(-1, *[1] * (d.dim() - 1)), src, d)
        d.copy_(src)


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                pos: torch.Tensor, caches: Cache,
                active: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """tokens (B,1); pos (B,) absolute positions. Updates ``caches`` in
    place (only rows where ``active``, when given: K/V writes and recurrent
    states alike) and returns (logits (B,V), caches)."""
    x = embed(cfg, params, tokens)
    for kind, i, p, inv in _walk(cfg, params):
        x = _constrain_acts(x)
        if kind == ATTN:
            x = _attn_block_decode(p, cfg, x, pos, caches[ATTN]["k"][i],
                                   caches[ATTN]["v"][i], None, active)
        else:
            state = _index(caches[kind], i)
            p = gather_fsdp(p)
            y, new = RECURRENT_DECODE[kind](
                p, cfg, rms_norm(x, p["norm"], cfg.rms_eps), state)
            x = _constrain_acts(x + y)
            _write_state(state, new, active)
        if inv is not None:
            scfg = _shared_cfg(cfg)
            x = _attn_block_decode(
                shared_params(params, cfg), scfg, x, pos,
                caches[SHARED]["k"][inv], caches[SHARED]["v"][inv],
                scfg.num_kv_heads, active)
    return logits_fn(cfg, params, x[:, 0]), caches


# --------------------------------------------------------------------------- #
# training
# --------------------------------------------------------------------------- #
def _attn_block_train(p, cfg, x, positions, kv_heads):
    """An attention block of the training forward: (x, MoE aux or None)."""
    p = gather_fsdp(p, skip=MOE)
    h = _block_input(x, p[ATTN_NORM], cfg)
    x = _residual(x, attention.attn_train(p, cfg, h, positions,
                                          kv_heads=kv_heads))
    y, aux = _ffn(p, cfg, _block_input(x, p[MLP_NORM], cfg))
    return _residual(x, y), aux


def _recurrent_block_train(p, cfg, x, kind):
    p = gather_fsdp(p)
    y, _ = RECURRENT_PREFILL[kind](p, cfg, _block_input(x, p["norm"], cfg))
    return _residual(x, y)


def forward_train(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                  embeds: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``forward_train`` with its default XLA attention:
    returns (logits (B,F+S,V) over the frontend's F embeddings and the S
    tokens, the MoE aux loss summed over the layers, a float32 scalar).
    Positions are 0..F+S-1. Under ``cfg.remat`` each layer and each
    shared-block invocation runs under ``torch.utils.checkpoint`` and is
    recomputed in the backward pass, as the reference checkpoints each
    layer. Differentiable: no cache is built and no kernel is called."""
    rows = tokens.shape[0]
    x = embed(cfg, params, _padded(tokens), _padded(embeds))
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(fn, *args):
        if not cfg.remat:
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)

    for kind, _, p, inv in _walk(cfg, params):
        x = _constrain_acts(x)
        if kind == ATTN:
            x, a = run(_attn_block_train, p, cfg, x, positions, None)
            if a is not None:
                aux = aux + a
        else:
            x = run(_recurrent_block_train, p, cfg, x, kind)
        if inv is not None:
            scfg = _shared_cfg(cfg)
            x, _ = run(_attn_block_train, shared_params(params, cfg), scfg,
                       x, positions, scfg.num_kv_heads)
    return unpad_rows(logits_fn(cfg, params, _whole_seq(x)), rows), aux
