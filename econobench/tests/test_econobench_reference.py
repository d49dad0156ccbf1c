"""The plain reference against the port's CPU path at a tiny width, on
the benchmark's own weights: the logits of every position agree in
float32."""
import dataclasses

import pytest
import torch

from econobench import harness
from econobench.weights import make_params

from conftest import tiny


def test_reference_equals_port_cpu(one_thread):
    from repro_torch.models import model
    c = tiny("nemo12b.chat")
    cfg = harness.port_config(c.conf)
    cfg = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params = make_params(cfg, 2**33 + 5, "cpu", torch.float32)
    ref = harness.load_module(harness.HERE / "references"
                              / f"{c.conf['reference']}.py")
    g = torch.Generator().manual_seed(0)
    seqs = [torch.randint(0, cfg.vocab_size, (n,), generator=g)
            for n in (37, 64)]
    want = ref.logits(harness.ref_config(cfg), params, seqs,
                      [torch.arange(len(s)) for s in seqs])
    for s, w in zip(seqs, want):
        got, _ = model.prefill(cfg, params, s[None])
        torch.testing.assert_close(got[0].float(), w, rtol=2e-4, atol=2e-4)


def test_weights_repeat_by_seed_and_follow_the_layout():
    from repro_torch.models import model
    cfg = harness.port_config(tiny("nemo12b.chat").conf)
    a = make_params(cfg, 2**31 + 3, "cpu")
    b = make_params(cfg, 2**31 + 3, "cpu")
    c = make_params(cfg, 2**31 + 4, "cpu")
    tree = model.param_tree(cfg)
    assert set(a) == set(tree)
    for n, m in tree.items():
        assert tuple(a[n].shape) == tuple(m.shape)
        assert a[n].dtype == torch.bfloat16
        assert torch.equal(a[n], b[n])
    assert not torch.equal(a["wq"], c["wq"])
    assert torch.equal(a["attn_norm"], torch.ones_like(a["attn_norm"]))
    std = a["w_down"].float().std().item()
    assert std == pytest.approx(128 ** -0.5, rel=0.1)
