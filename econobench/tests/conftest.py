"""The benchmark's own tests: the yardstick's arithmetic on the CPU, the
reference against the port's CPU path at a tiny width, the control and a
planted fault, the import check. Run from the repo root:

    python -m pytest -q econobench/tests

Tests marked ``gpu`` need a CUDA card and skip without one."""
import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from econobench import env  # noqa: E402

env.setup()

TINY = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16, intermediate_size=128,
            vocab_size=512)


def tiny(name: str, **spec):
    """Cell ``name`` at a width the CPU runs in seconds: the same loop,
    engine, reference and check, with short lengths, 4 rows of 96 slots
    (a closed loop: 6 clients); ``spec`` overrides the cell's settings."""
    from econobench import harness
    cell = harness.load_cell(name)
    conf = dict(cell.conf, **TINY)
    mix = dict(cell.mix, prompt=dict(cell.mix["prompt"], min=4, max=60),
               output=dict(cell.mix["output"], min=6, max=20))
    s = dict(cell.spec, rows=4, capacity=96, preroll_s=0.5,
             trace_slice=[0.6, 0.3], rate=6.0)
    if s["loop"] == "closed":
        s.update(clients=6, max_rate=30.0)
    s.update(spec)
    return dataclasses.replace(cell, conf=conf, mix=mix, spec=s)


@pytest.fixture
def one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
