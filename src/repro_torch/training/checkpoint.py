"""Checkpoints in the reference's msgpack layout (``repro.training.
checkpoint``): nested dicts flattened with their keys joined by the ASCII
unit separator, each leaf ``{dtype, shape, data}`` with its raw bytes.
bfloat16 is stored under the dtype name ``"bfloat16"``, as the reference
writes it, and read back through a 16-bit view. Params and the moments of
an optimizer state are written under the reference's parameter paths
(``weights.JAX_TO_PORT``), so a file saved by either package loads in the
other. ``msgpack`` is imported only by ``save`` and ``load``."""
from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from ..distributed.dtensor import is_dtensor
from ..models.weights import JAX_TO_PORT, jax_names

# parameter names themselves contain "/", so nested-dict paths are joined
# with the ASCII unit separator instead
_SEP = "\x1f"


def _record(leaf) -> Dict[str, Any]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tobytes()}


def _tensor(rec: Dict[str, Any]) -> torch.Tensor:
    if rec["dtype"] == "bfloat16":
        arr = np.frombuffer(rec["data"], dtype=np.int16)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16).reshape(
            rec["shape"])
    arr = np.frombuffer(rec["data"], dtype=np.dtype(rec["dtype"]))
    return torch.from_numpy(arr.copy()).reshape(rec["shape"])


def _pack(tree: Dict[str, Any]) -> bytes:
    import msgpack
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}{_SEP}{k}" if prefix else k, v)
        else:
            flat[prefix] = _record(node)

    walk("", tree)
    return msgpack.packb(flat, use_bin_type=True)


def _unpack(blob: bytes) -> Dict[str, Any]:
    import msgpack
    tree: Dict[str, Any] = {}
    for path, rec in msgpack.unpackb(blob, raw=False).items():
        node = tree
        parts = path.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _tensor(rec)
    return tree


def _port_names(flat: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {JAX_TO_PORT[k]: v for k, v in flat.items()}


def _full(tree):
    """DTensor leaves as full tensors (a collective every rank joins)."""
    if isinstance(tree, dict):
        return {k: _full(v) for k, v in tree.items()}
    return tree.full_tensor() if is_dtensor(tree) else tree


def save(path: str, params: Dict[str, torch.Tensor],
         opt_state: Dict[str, Any] | None = None,
         meta: Dict[str, Any] | None = None) -> None:
    """Write port params (and an optimizer state, and scalars in ``meta``)
    under the reference's names. DTensors are gathered whole on every rank
    (each rank must call ``save``) and rank 0 writes the file."""
    params, opt_state = _full(params), _full(opt_state)
    if torch.distributed.is_initialized() and torch.distributed.get_rank():
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload: Dict[str, Any] = {"params": jax_names(params)}
    if opt_state is not None:
        payload["opt_state"] = {**opt_state, "m": jax_names(opt_state["m"]),
                                "v": jax_names(opt_state["v"])}
    if meta is not None:
        payload["__meta__"] = {k: np.asarray(v) for k, v in meta.items()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_pack(payload))
    os.replace(tmp, path)


def load(path: str) -> Dict[str, Any]:
    """The saved tree as CPU tensors, params and moments under the port's
    names."""
    with open(path, "rb") as f:
        tree = _unpack(f.read())
    if "params" in tree:
        tree["params"] = _port_names(tree["params"])
    st = tree.get("opt_state")
    if st is not None:
        st.update(m=_port_names(st["m"]), v=_port_names(st["v"]))
    return tree
