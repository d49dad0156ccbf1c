"""The control and a planted fault, driven through the harness at a width
the CPU holds (the chip readings that set each cell's limit are in
``PERF.md``).

* The control, the reference in the program's place at the precision
  below bf16 (both operands of every matrix product in float8 e4m3),
  lies far further below the reference's best than the served tokens
  do, by the cell's number, through the comparison itself, on every
  seed, and comes out not correct at a limit between the two.
* A served token altered where it is produced (each sampled token moved
  to its neighbour in the vocabulary) makes ``correct`` false at the
  cell's own limit, with the rest of the run as it is: engine, loop,
  sample, reference and comparison."""
from types import SimpleNamespace

import pytest

from econobench import harness

from conftest import tiny

CELLS = ["nemo12b.chat", "nemo12b.docs"]


@pytest.mark.parametrize("seed", [3, 2**31 + 17, 7_777_777_777])
@pytest.mark.parametrize("cell", CELLS)
def test_control_lies_below_the_served_tokens(cell, seed, one_thread):
    c = tiny(cell)
    mcfg, params, eng, served = harness.serve(c, seed, 1.0, False, "cpu")
    harness.free(eng)
    ref = harness.load_module(harness.HERE / "references"
                              / f"{c.conf['reference']}.py")
    sample = harness.pick(served.done, c.spec["check"]["requests"], seed)
    g = harness.gaps(ref, harness.ref_config(mcfg), params, sample)
    number = c.spec["check"]["number"]
    assert g["tokens"] >= 10
    # the control in the program's place, through the comparison itself
    ctl = harness.control_sample(ref, harness.ref_config(mcfg), params,
                                 sample)
    assert [(p, o) for p, o, _ in ctl] == sample
    assert [len(x) for _, _, x in ctl] == [len(o) for _, o in sample]
    ok, out = harness.check(c, mcfg, params, SimpleNamespace(done=ctl),
                            seed)
    assert out[number]["value"] > 2 * g[number]
    # at a limit between the two readings (the card's limits: PERF.md) the
    # program is correct and the control is not
    c.spec["check"] = dict(c.spec["check"], limit=2 * g[number] + 1e-6)
    assert harness.check(c, mcfg, params, served, seed)[0]
    assert not harness.check(c, mcfg, params, SimpleNamespace(done=ctl),
                             seed)[0]


def _altered(sample):
    """A sampler that returns each token's neighbour."""
    def fn(*a, **kw):
        return (sample(*a, **kw) + 1) % fn.vocab
    return fn


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_token_is_not_correct(cell, monkeypatch, one_thread):
    from repro_torch.serving import engine as E
    c = tiny(cell)
    number, limit = c.spec["check"]["number"], c.spec["check"]["limit"]
    ok, out = _run(c)
    assert ok, out
    for name in ("sample_in_graph", "sample_per_request"):
        fn = _altered(getattr(E, name))
        fn.vocab = harness.port_config(c.conf).vocab_size
        monkeypatch.setattr(E, name, fn)
    ok, out = _run(c)
    assert not ok and out[number]["value"] > limit, out


def _run(c):
    mcfg, params, eng, served = harness.serve(c, 11, 1.0, False, "cpu")
    harness.free(eng)
    return harness.check(c, mcfg, params, served, 11)


@pytest.mark.gpu
def test_a_short_run_on_the_card_is_correct():
    """The tiny cell through the port's CUDA kernels on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    c = tiny("nemo12b.chat")
    c.spec["check"] = harness.load_cell("nemo12b.chat").spec["check"]
    mcfg, params, eng, served = harness.serve(c, 5, 1.0, False, "cuda")
    harness.free(eng)
    ok, out = harness.check(c, mcfg, params, served, 5)
    assert ok, out
