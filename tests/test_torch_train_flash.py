"""The training forward's streaming flash attention (``flash_xla``, the
reference's ``_flash_jnp``): qwen3 at S = 2304 > ``FLASH_THRESHOLD``
against the reference's loss and gradients (``test_torch_train_model.py``'s
tolerances), and ``flash_xla`` against the dense ``sdpa`` in values and
gradients."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import attention  # noqa: E402
from test_torch_train_model import (assert_close, both, cfgs,  # noqa: E402
                                    one_torch_thread)  # noqa: F401


def test_flash_path_above_the_threshold_matches_the_reference():
    """S = 2304 crosses ``FLASH_THRESHOLD``: five q blocks of 512 (the last
    padded) over three k blocks of 1024 (the last padded) on both sides."""
    jcfg, cfg = cfgs("qwen3_8b", dict(layers=1, d_model=64, vocab=128))
    S = 2304
    assert S > attention.FLASH_THRESHOLD
    assert_close(*both(jcfg, cfg, 1, S))


def test_flash_xla_equals_sdpa_under_the_mask():
    """The streaming form and the dense one are the same function: values
    and gradients on a causal, windowed, softcapped problem of three q
    blocks over two k blocks, the last of each padded."""
    _, cfg = cfgs("qwen3_8b")
    cfg = cfg.with_(sliding_window=600, attn_logit_softcap=30.0)
    g = torch.Generator().manual_seed(0)
    B, S, H, K, hd = 1, 1100, 4, 2, 16
    q, k, v = (torch.randn(B, S, n, hd, generator=g, requires_grad=True)
               for n in (H, K, K))
    pos = torch.arange(S)[None].expand(B, S)
    ii, jj = pos[:, :, None], pos[:, None, :]
    mask = (jj <= ii) & (jj > ii - cfg.sliding_window)
    want = attention.sdpa(q, k, v, mask, cfg)
    got = attention.flash_xla(q, k, v, pos, pos, cfg)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    gw = torch.autograd.grad(want.square().sum(), (q, k, v))
    gg = torch.autograd.grad(got.square().sum(), (q, k, v))
    for a, b in zip(gg, gw):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
