"""xLSTM blocks in PyTorch, mirroring ``repro.models.xlstm``: mLSTM (matrix
memory; chunkwise stabilised prefill carrying (C, n, m), recurrent decode)
and sLSTM (scalar memory with exponential gating; a sequential scan).

Plain PyTorch, as the reference is plain ``jnp``: a Python loop over
chunks (mLSTM) or steps (sLSTM) takes the place of ``lax.scan``. The
memory states stay float32.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..distributed.dtensor import (blockwise, is_dtensor, merge_heads,
                                   replicate, rows_heads, split_heads)
from ..kernels import traced
from .common import EMBED, INNER, NUL, ParamMeta, ParamTree, rms_norm
from .config import ModelConfig

NEG = -1e30


def _dims(cfg: ModelConfig):
    di = int(cfg.xlstm_proj_factor * cfg.d_model)
    nh = cfg.num_heads
    hd = di // nh
    return di, nh, hd


# --------------------------------------------------------------------------- #
# mLSTM
# --------------------------------------------------------------------------- #
def mlstm_params(cfg: ModelConfig) -> ParamTree:
    """The reference's ``mlstm_params``; its output-norm scale ``norm`` is
    ``out_norm`` here, apart from the block's own pre-norm."""
    d = cfg.d_model
    di, nh, hd = _dims(cfg)
    return {
        "wq": ParamMeta((d, di), (EMBED, INNER)),
        "wk": ParamMeta((d, di), (EMBED, INNER)),
        "wv": ParamMeta((d, di), (EMBED, INNER)),
        "wi": ParamMeta((d, nh), (EMBED, NUL), init="small"),
        "wf": ParamMeta((d, nh), (EMBED, NUL), init="small"),
        "bf": ParamMeta((nh,), (NUL,), init="ones"),
        "wo": ParamMeta((d, di), (EMBED, INNER), init="small"),
        "out_norm": ParamMeta((di,), (INNER,), init="ones"),
        "down": ParamMeta((di, d), (INNER, EMBED)),
    }


def _qkvif(p, cfg, x):
    di, nh, hd = _dims(cfg)
    q = split_heads(x @ p["wq"], nh, hd)
    k = split_heads(x @ p["wk"], nh, hd) / math.sqrt(hd)
    v = split_heads(x @ p["wv"], nh, hd)
    i_raw = (x @ p["wi"]).float()
    f_raw = (x @ p["wf"] + p["bf"]).float()
    return q, k, v, i_raw, f_raw


def _mlstm_chunk(state, qc, kc, vc, ic, fc, tri):
    """One chunk of the stabilised chunkwise form: qc/kc/vc (B,Q,nh,hd),
    ic/fc (B,Q,nh) input gate and log forget gate, state (C, n, m).
    Returns (new state, y (B,Q,nh,hd))."""
    C_prev, n_prev, m_prev = state
    bcum = torch.cumsum(fc, dim=1)                            # (B,Q,nh)
    total = bcum[:, -1]                                       # (B,nh)
    # intra-chunk decay matrix  logD[i,j] = bcum_i - bcum_j + i_j
    seg = bcum[:, :, None, :] - bcum[:, None, :, :] + ic[:, None, :, :]
    seg = seg.masked_fill(~tri[None, :, :, None], float("-inf"))
    m_intra = torch.clamp(seg.amax(dim=2), min=NEG)           # (B,Q,nh)
    m_inter = bcum + m_prev[:, None, :]
    m_t = torch.maximum(m_intra, m_inter)
    D = torch.exp(seg - m_t[:, :, None, :])                   # (B,Q,Q,nh)
    qk = torch.einsum("bshd,bthd->bsth", qc, kc)
    w = qk * D
    h_intra = torch.einsum("bsth,bthd->bshd", w, vc)
    scale_in = torch.exp(m_inter - m_t)
    h_inter = torch.einsum("bshd,bhed->bshe", qc, C_prev) * scale_in[..., None]
    num = h_intra + h_inter
    # denominator n_t.q_t: intra = sum_j w[s,j]; inter = (q.n_prev) decay
    dq = w.sum(dim=2) + torch.einsum("bshd,bhd->bsh", qc, n_prev) * scale_in
    denom = torch.maximum(dq.abs(), torch.exp(-m_t))
    y = num / torch.clamp(denom, min=1e-6)[..., None]
    # ---- state update to chunk end ----------------------------------------
    m_cand = total[:, None, :] - bcum + ic                    # (B,Q,nh)
    m_next = torch.maximum(total + m_prev, m_cand.amax(dim=1))
    wk = torch.exp(m_cand - m_next[:, None, :])
    decay = torch.exp(total + m_prev - m_next)
    C_new = decay[:, :, None, None] * C_prev \
        + torch.einsum("bthd,bthe->bhde", wk[..., None] * vc, kc)
    n_new = decay[:, :, None] * n_prev \
        + torch.einsum("bth,bthd->bhd", wk, kc)
    return (C_new, n_new, m_next), y


def _mlstm_scan(q, k, v, i_raw, log_f, C0, n0, m0, Q: int):
    """The chunk loop: q/k/v (B,S,nh,hd), i_raw/log_f (B,S,nh), S a
    multiple of Q, from the state (C0, n0, m0) (None: the empty memory).
    Returns (y (B,S,nh,hd) float32, C, n, m)."""
    B, S, nh, hd = q.shape
    tri = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    if C0 is not None:
        state = (C0, n0, m0)
    else:
        state = (torch.zeros((B, nh, hd, hd), dtype=torch.float32,
                             device=q.device),
                 torch.zeros((B, nh, hd), dtype=torch.float32,
                             device=q.device),
                 torch.full((B, nh), NEG, dtype=torch.float32,
                            device=q.device))
    ys = []
    for c0 in range(0, S, Q):
        sl = slice(c0, c0 + Q)
        state, y = _mlstm_chunk(state, q[:, sl].float(), k[:, sl].float(),
                                v[:, sl].float(), i_raw[:, sl], log_f[:, sl],
                                tri)
        ys.append(y)
    return (torch.cat(ys, dim=1), *state)


def mlstm_prefill(p, cfg: ModelConfig, x: torch.Tensor, init=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunkwise-parallel stabilised mLSTM over chunks of ``ssm_chunk``:
    padded steps get forget gate 1 (raw 40) and input gate -inf (raw
    -1e30). ``init`` (a previous call's cache) resumes the recurrence;
    ``None`` is the empty memory."""
    B, S0, _ = x.shape
    di, nh, hd = _dims(cfg)
    q, k, v, i_raw, f_raw = _qkvif(p, cfg, x)
    Q = min(cfg.ssm_chunk, S0)
    S = -(-S0 // Q) * Q
    if S != S0:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, S - S0)) for t in (q, k, v))
        i_raw = F.pad(i_raw, (0, 0, 0, S - S0), value=NEG)
        f_raw = F.pad(f_raw, (0, 0, 0, S - S0), value=40.0)
    log_f = blockwise(F.logsigmoid, f_raw)
    init = (init["C"], init["n"], init["m"]) if init is not None \
        else (None, None, None)
    args = (q, k, v, i_raw, log_f, *init, Q)
    if is_dtensor(q):       # under a mesh: each rank's rows and heads
        y, C, nvec, m_end = rows_heads(
            _mlstm_scan, args, ((0, 2),) * 3 + ((0, 2),) * 2
            + ((0, 1),) * 3 + (None,), ((0, 2), (0, 1), (0, 1), (0, 1)))
    else:
        y, C, nvec, m_end = _mlstm_scan(*args)
    y = merge_heads(y)[:, :S0].to(x.dtype)
    y = rms_norm(y, p["out_norm"], cfg.rms_eps)
    y = y * torch.sigmoid(x @ p["wo"])
    return y @ p["down"], {"C": C, "n": nvec, "m": m_end}


def mlstm_decode(p, cfg: ModelConfig, x: torch.Tensor,
                 cache: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B = x.shape[0]
    di, nh, hd = _dims(cfg)
    q, k, v, i_raw, f_raw = _qkvif(p, cfg, x)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    i_raw, log_f = i_raw[:, 0], blockwise(F.logsigmoid, f_raw[:, 0])
    m_old, C_old, n_old = cache["m"], cache["C"], cache["n"]
    m_new = torch.maximum(log_f + m_old, i_raw)
    a = torch.exp(log_f + m_old - m_new)                      # (B,nh)
    b = torch.exp(i_raw - m_new)
    C = a[:, :, None, None] * C_old \
        + b[:, :, None, None] * (v[..., :, None] * k[..., None, :])
    n = a[:, :, None] * n_old + b[:, :, None] * k
    # elementwise on a DTensor (a matmul would flatten the sharded (B, nh))
    num = (C * q[:, :, None, :]).sum(-1) if is_dtensor(C) \
        else (C @ q[..., None])[..., 0]
    den = torch.maximum((n * q).sum(dim=-1).abs(), torch.exp(-m_new))[..., None]
    y = merge_heads(num / torch.clamp(den, min=1e-6))[:, None].to(x.dtype)
    y = rms_norm(y, p["out_norm"], cfg.rms_eps)
    y = y * torch.sigmoid(x @ p["wo"])
    return y @ p["down"], {"C": C, "n": n, "m": m_new}


def mlstm_init_cache(cfg: ModelConfig, batch: int, device=None
                     ) -> Dict[str, torch.Tensor]:
    di, nh, hd = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, nh, hd, hd), **f32),
            "n": torch.zeros((batch, nh, hd), **f32),
            "m": torch.full((batch, nh), NEG, **f32)}


# --------------------------------------------------------------------------- #
# sLSTM
# --------------------------------------------------------------------------- #
def slstm_params(cfg: ModelConfig) -> ParamTree:
    """The reference's ``slstm_params``, with ``norm`` as ``out_norm``."""
    d = cfg.d_model
    di, nh, hd = _dims(cfg)
    return {
        "w_in": ParamMeta((d, 4 * di), (EMBED, INNER)),
        "r": ParamMeta((nh, hd, 4 * hd), (NUL, NUL, INNER), init="small"),
        "b": ParamMeta((4 * di,), (INNER,), init="zeros"),
        "out_norm": ParamMeta((di,), (INNER,), init="ones"),
        "down": ParamMeta((di, d), (INNER, EMBED)),
    }


def _whole_r(p):
    """The recurrent kernel ``r`` (nh, hd, 4hd) whole on every rank under a
    mesh: its spec shards the last dim, and the step's product would
    then flatten (nh, 4hd) with the inner dim sharded."""
    return dict(p, r=replicate(p["r"]))


def _slstm_step(p, cfg, xt, state):
    """xt (B, 4*di) pre-projected input; state dict of (B, di) fp32."""
    di, nh, hd = _dims(cfg)
    B = xt.shape[0]
    c, n, h, m = state["c"], state["n"], state["h"], state["m"]
    rec = (split_heads(h, nh, hd).to(xt.dtype).transpose(0, 1) @ p["r"]
           ).transpose(0, 1).reshape(B, 4 * di)
    zifo = (xt + rec).float() + p["b"].float()
    z, i_raw, f_raw, o = torch.split(zifo, di, dim=-1)
    z = torch.tanh(z)
    log_f = blockwise(F.logsigmoid, f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    a = torch.exp(log_f + m - m_new)
    b = torch.exp(i_raw - m_new)
    c_new = a * c + b * z
    n_new = a * n + b
    h_new = torch.tanh(c_new / torch.clamp(n_new, min=1e-6)) * torch.sigmoid(o)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def slstm_init_cache(cfg: ModelConfig, batch: int, device=None
                     ) -> Dict[str, torch.Tensor]:
    di, _, _ = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, di), **f32),
            "n": torch.zeros((batch, di), **f32),
            "h": torch.zeros((batch, di), **f32),
            "m": torch.full((batch, di), NEG, **f32)}


def slstm_prefill(p, cfg: ModelConfig, x: torch.Tensor, init=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The sequential scan; ``init`` (a previous call's cache) resumes the
    recurrence, ``None`` is the zero state."""
    B, S, _ = x.shape
    xproj = x @ p["w_in"]                                     # (B,S,4di)
    state = init if init is not None else slstm_init_cache(cfg, B, x.device)
    names = ("c", "n", "h", "m")

    def scan(xproj, r, b, *st):
        st = dict(zip(names, st))
        if traced(xproj):
            # a FakeTensorMode trace (the dry-run) takes the body once, as
            # lax.scan traces it: y is empty, the state has one step's
            # shapes; S fake steps of every layer would take minutes
            st = _slstm_step({"r": r, "b": b}, cfg, xproj[:, 0], st)
            y = st["h"].new_empty((xproj.shape[0], S, st["h"].shape[-1]))
            return (y, *(st[k] for k in names))
        hs = []
        for t in range(S):
            st = _slstm_step({"r": r, "b": b}, cfg, xproj[:, t], st)
            hs.append(st["h"])
        return (torch.stack(hs, dim=1), *(st[k] for k in names))

    args = (xproj, p["r"], p["b"], *(state[k] for k in names))
    if is_dtensor(xproj):   # under a mesh: each rank's rows, every head
        y, *st = rows_heads(scan, args, ((0, None), (None, None),
                                         (None, None)) + ((0, None),) * 4,
                            ((0, None),) * 5)
    else:
        y, *st = scan(*args)
    state = dict(zip(names, st))
    y = y.to(x.dtype)                                         # (B,S,di)
    y = rms_norm(y, p["out_norm"], cfg.rms_eps)
    return y @ p["down"], state


def slstm_decode(p, cfg: ModelConfig, x: torch.Tensor, cache
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    state = _slstm_step(_whole_r(p), cfg, (x @ p["w_in"])[:, 0], cache)
    y = state["h"][:, None].to(x.dtype)
    y = rms_norm(y, p["out_norm"], cfg.rms_eps)
    return y @ p["down"], state
