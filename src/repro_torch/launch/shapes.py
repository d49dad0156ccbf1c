"""Assigned input shapes x step builders for the dry-run and launchers.

Shapes (assigned to this paper):
  train_4k     seq 4,096   global_batch 256   train_step
  prefill_32k  seq 32,768  global_batch 32    prefill step
  decode_32k   seq 32,768  global_batch 128   serve_step (1 token vs cache)
  long_500k    seq 524,288 global_batch 1     serve_step, sub-quadratic only

``long_500k`` policy (DESIGN.md §4): SSM/hybrid run natively; dense/MoE/
VLM/audio run the sliding-window (8192) attention variant; zamba2's 14
shared-attention caches are sequence-sharded over the "data" axis.

``build_step`` returns the step and its arguments as DTensors on the mesh:
empty shards on ``meta`` (or fake tensors under ``FakeTensorMode``) for the
dry-run, seeded values on a real device for a run. Each step runs eagerly
under ``implicit_replication``, so plain tensors made inside the model
(positions, masks) act as replicated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.dtensor import is_dtensor
from repro_torch.models import model
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_loop import make_train_step

LONG_WINDOW = 8192
# Serving (prefill/decode) replicates weights across the data axis when a
# model-parallel shard of them takes at most half a card's memory (half an
# H100's 80 GB); above that it FSDPs them, as training always does.
SERVING_FSDP_BYTES = 80e9 / 2


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def adapt_config(cfg: ModelConfig, shape: ShapeSpec) -> ModelConfig:
    """Per-shape config adaptation (window variant for long-context dense;
    bf16 optimizer states for the 480B MoE — DESIGN.md §5)."""
    if shape.name == "long_500k" and cfg.has_attention \
            and cfg.arch_type not in ("ssm", "hybrid") \
            and cfg.sliding_window is None:
        cfg = cfg.with_(sliding_window=LONG_WINDOW)
    return cfg


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    if shape.name == "long_500k":
        c = adapt_config(cfg, shape)
        if not c.supports_long_context:
            return False, "pure full-attention arch at 500k context"
    return True, ""


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    # 480B-scale MoE: bf16 moments to fit one pod (DESIGN.md §5)
    if cfg.is_moe and cfg.num_experts >= 64:
        return AdamWConfig(state_dtype="bfloat16")
    return AdamWConfig()


# --------------------------------------------------------------------------- #
def serving_fsdp(cfg: ModelConfig, mesh) -> bool:
    """Whether serving FSDPs the weights: a model-parallel shard of the
    bf16 weights above ``SERVING_FSDP_BYTES``."""
    from repro_torch.core.costmodel import _param_count
    model_axis = shd.axis_sizes(mesh)["model"]
    return _param_count(cfg)["total"] * 2 / model_axis > SERVING_FSDP_BYTES


class _Args:
    """Makes the step's arguments: empty shards on ``device`` when ``seed``
    is None, else seeded values (the same full tensor on every rank, of
    which each keeps its block)."""

    def __init__(self, mesh, device, seed: Optional[int]):
        self.mesh, self.device = mesh, torch.device(device)
        self.gen = None if seed is None else \
            torch.Generator(self.device).manual_seed(seed)

    def tensor(self, shape, dtype, spec, fill: Callable = None):
        if self.gen is None:
            return shd.abstract_dtensor(shape, dtype, spec, self.mesh,
                                        self.device)
        full = torch.zeros(shape, dtype=dtype, device=self.device)
        if fill is not None:
            fill(full, self.gen)
        return shd.shard_tensor(full, spec, self.mesh)

    def params(self, cfg: ModelConfig, fsdp: bool):
        if self.gen is None:
            return shd.shard_params_abstract(cfg, self.mesh, fsdp=fsdp,
                                             device=self.device)
        full = model.init(cfg, self.gen, self.device)
        return shd.shard_params(full, cfg, self.mesh, fsdp=fsdp)


def _tokens(vocab: int):
    return lambda t, g: t.random_(0, vocab, generator=g)


def _normal(t: torch.Tensor, g) -> None:
    for row in t.view(-1, t.shape[-1]).split(1 << 20):
        row.normal_(generator=g)


def abstract_cache(cfg: ModelConfig, mesh, batch: int, capacity: int, *,
                   shard_batch: bool, shard_seq: bool, args: _Args = None):
    """The decode caches of ``model.init_cache`` as DTensors under
    ``cache_specs`` (empty, or seeded normal values with ``args``)."""
    args = args or _Args(mesh, "meta", None)
    shapes = model.init_cache(cfg, batch, capacity, device="meta")
    specs = shd.cache_specs(cfg, mesh, batch=batch, capacity=capacity,
                            shard_batch=shard_batch, shard_seq=shard_seq)
    return {kind: {n: args.tensor(t.shape, t.dtype, specs[kind][n],
                                  _normal)
                   for n, t in sub.items()}
            for kind, sub in shapes.items()}


def _argmax(logits: torch.Tensor) -> torch.Tensor:
    """The greedy token of (B, V) logits as int32; a vocab-sharded DTensor
    is gathered along the vocab first (one all-gather over "model")."""
    if is_dtensor(logits):
        last = logits.dim() - 1
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if p.is_shard() and p.dim == last else p
            for p in logits.placements])
    return logits.argmax(dim=-1).to(torch.int32)


def _replicated_step(fn: Callable) -> Callable:
    def step(*a):
        from torch.distributed.tensor.experimental import \
            implicit_replication
        with implicit_replication(), torch.no_grad():
            return fn(*a)
    return step


def build_step(cfg: ModelConfig, shape: ShapeSpec, mesh, *,
               device="meta", seed: Optional[int] = None
               ) -> Tuple[Callable, tuple, dict]:
    """Returns (step_fn, args, kwargs): ``step_fn(*args)`` runs one step;
    ``kwargs["donate_argnums"]`` names the arguments the step updates in
    place (the reference's donated buffers). Declares the mesh's axes
    (``common.set_mesh_axes``) for the model's constraints."""
    cfg = adapt_config(cfg, shape)
    from repro_torch.models.common import set_mesh_axes
    sizes = shd.axis_sizes(mesh)
    set_mesh_axes(shd.axis_names(mesh), sizes, mesh=mesh)
    ba = shd.batch_axes(mesh)
    bspec = (ba,) if ba else (None,)
    # Serving replicates weights across the data axis when they fit
    # model-parallel-only — FSDP all-gathers per layer are pure overhead
    # for inference. Training always FSDPs.
    fsdp = shape.kind == "train" or serving_fsdp(cfg, mesh)
    args = _Args(mesh, device, seed)
    params = args.params(cfg, fsdp)
    F = cfg.frontend_tokens if cfg.frontend else 0
    B = shape.global_batch
    act = model.dtype_of(cfg.dtype)

    def batch_of() -> dict:
        batch = {"tokens": args.tensor((B, shape.seq_len - F), torch.int32,
                                       bspec + (None,),
                                       _tokens(cfg.vocab_size))}
        if F:
            batch["embeds"] = args.tensor((B, F, cfg.d_model), act,
                                          bspec + (None, None), _normal)
        return batch

    if shape.kind == "train":
        opt = opt_config_for(cfg)
        train_step = make_train_step(cfg, opt)
        sdt = model.dtype_of(opt.state_dtype)
        specs = shd.param_specs(cfg, mesh, fsdp=True)
        tree = model.param_tree(cfg)
        opt_state = {m: {k: args.tensor(tree[k].shape, sdt, specs[k])
                         for k in tree} for m in ("m", "v")}
        opt_state["step"] = torch.zeros((), dtype=torch.int32,
                                        device=args.device)

        def step(params, opt_state, batch):
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                return train_step(params, opt_state, batch)

        return step, (params, opt_state, batch_of()), \
            dict(donate_argnums=(0, 1))

    if shape.kind == "prefill":
        def prefill_step(params, batch):
            logits, caches = model.prefill(cfg, params, batch["tokens"],
                                           batch.get("embeds"),
                                           last_only=True)
            return _argmax(logits), caches

        return _replicated_step(prefill_step), (params, batch_of()), {}

    # decode: one token per row at position seq_len - 1 (a full context)
    shard_batch = B > 1
    shard_seq = not shard_batch
    capacity = shape.seq_len

    def serve_step(params, tokens, pos, caches):
        logits, caches = model.decode_step(cfg, params, tokens, pos, caches)
        return _argmax(logits), caches

    tok_spec = bspec if shard_batch else (None,)
    tokens = args.tensor((B, 1), torch.int32, tok_spec + (None,),
                         _tokens(cfg.vocab_size))
    pos = args.tensor((B,), torch.int32, tok_spec,
                      lambda t, g: t.fill_(capacity - 1))
    caches = abstract_cache(cfg, mesh, B, capacity, shard_batch=shard_batch,
                            shard_seq=shard_seq, args=args)
    return _replicated_step(serve_step), (params, tokens, pos, caches), \
        dict(donate_argnums=(3,))
