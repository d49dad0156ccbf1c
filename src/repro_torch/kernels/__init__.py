"""Hand-written CUDA kernels for the serving hot spots (flash prefill
attention and paged decode attention), their plain PyTorch versions, and
the build that compiles them on first use."""
from __future__ import annotations


def refuse_grad(name: str, *tensors) -> None:
    """The kernels have no backward (nor does the reference's Pallas pair),
    and a ctypes launch returns a tensor with no ``grad_fn``: a wrapper
    raises rather than lose a gradient, on every device."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; an input "
                           f"requires grad (training attention is "
                           f"models.attention.attn_train)")


def traced(t) -> bool:
    """Whether ``t`` is a fake tensor (a trace under ``FakeTensorMode``,
    as the dry-run makes): a wrapper then returns an empty output of its
    kernel's shape and dtype (the kernel's fake implementation, what
    ``torch.library.register_fake`` would give) and launches nothing."""
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(t)
