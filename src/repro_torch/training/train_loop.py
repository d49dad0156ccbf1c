"""Training step and loop, mirroring ``repro.training.train_loop``: the
loss scores text positions only (plus ``aux_loss_coef`` x the MoE aux
loss), gradients come from ``torch.autograd.grad`` over the params as leaf
tensors, and AdamW updates them. Remat lives inside the model's forward
(``cfg.remat``)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor.experimental import implicit_replication

from ..distributed import sharding as shd
from ..distributed.dtensor import is_dtensor
from ..models import model
from ..models.common import cross_entropy
from ..models.config import ModelConfig
from .optimizer import AdamWConfig, apply_updates, init_state


def make_loss_fn(cfg: ModelConfig):
    F = cfg.frontend_tokens if cfg.frontend else 0

    def loss_fn(params, batch):
        tokens = batch["tokens"]
        embeds = batch.get("embeds")
        logits, aux = model.forward_train(cfg, params, tokens, embeds)
        logits = logits[:, F:]                       # text positions only
        loss = cross_entropy(logits[:, :-1], tokens[:, 1:])
        if cfg.is_moe:
            loss = loss + cfg.aux_loss_coef * aux
        return loss, aux

    return loss_fn


def make_grad_fn(cfg: ModelConfig) -> Callable:
    """``grad_fn(params, batch) -> (loss, aux, grads)``: the first half of
    a train step. The params become leaf tensors that require grad; a
    param the loss does not reach gets a zero gradient, as ``jax.grad``
    gives it."""
    loss_fn = make_loss_fn(cfg)

    def grad_fn(params, batch):
        leaves = list(params.values())
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, aux = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), aux.detach(), dict(zip(params, grads))

    return grad_fn


def make_train_step(cfg: ModelConfig, opt: AdamWConfig) -> Callable:
    grad_fn = make_grad_fn(cfg)

    def train_step(params, opt_state, batch):
        """One step; ``params`` and the moments are updated in place (see
        ``apply_updates``) and returned with the metrics as 0-d tensors."""
        loss, aux, grads = grad_fn(params, batch)
        params, opt_state, gnorm = apply_updates(params, grads, opt_state,
                                                 opt)
        metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm}
        return params, opt_state, metrics

    return train_step


def batch_to(batch: Dict[str, np.ndarray], cfg: ModelConfig, device
             ) -> Dict[str, torch.Tensor]:
    """A ``SyntheticDataset`` batch on ``device``, embeds in ``cfg.dtype``."""
    out = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    if "embeds" in out:
        out["embeds"] = out["embeds"].to(model.dtype_of(cfg.dtype))
    return out


def _value(t: torch.Tensor) -> float:
    return float(t.full_tensor() if is_dtensor(t) else t)


def train(cfg: ModelConfig, steps: int, *, opt: Optional[AdamWConfig] = None,
          batch_size: int = 8, seq_len: int = 128, seed: int = 0,
          log_every: int = 10, callback=None, device=None, mesh=None):
    """Training loop on seeded random weights and the synthetic data; on
    the card unless ``device`` says otherwise. With a ``DeviceMesh`` (the
    caller declares its axes, ``common.set_mesh_axes``) the params and
    moments are DTensors under ``sharding.param_specs`` and each batch is
    split over the batch axes; every rank draws the same weights and
    batches. Returns (params, opt_state, history)."""
    from .data import DataConfig, SyntheticDataset

    opt = opt or AdamWConfig()
    dev = torch.device(device if device is not None else "cuda")
    params = model.init(cfg, torch.Generator(dev).manual_seed(seed), dev)
    if mesh is not None:
        params = shd.shard_params(params, cfg, mesh)
    opt_state = init_state(params, opt)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                      batch_size=batch_size, seed=seed,
                      frontend_tokens=cfg.frontend_tokens if cfg.frontend
                      else 0, d_model=cfg.d_model)
    ds = SyntheticDataset(dcfg)
    step_fn = make_train_step(cfg, opt)
    history = []
    for i, batch in enumerate(ds.batches()):
        if i >= steps:
            break
        batch = batch_to(batch, cfg, dev)
        if mesh is None:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
        else:
            rows = (shd.batch_axes(mesh),)
            batch = {k: shd.shard_tensor(v, rows + (None,) * (v.dim() - 1),
                                         mesh) for k, v in batch.items()}
            with implicit_replication():
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch)
        if i % log_every == 0 or i == steps - 1:
            m = {k: _value(v) for k, v in metrics.items()}
            history.append({"step": i, **m})
            if callback:
                callback(i, m)
    return params, opt_state, history
