"""``tests/test_training.py``'s scenarios on the port, on the CPU: the loss
falls for a dense and a MoE stack, AdamW keeps bf16 moments, and a
checkpoint round-trips; plus the launcher
(``python -m repro_torch.launch.train``)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.training.optimizer import AdamWConfig  # noqa: E402
from repro_torch.training.train_loop import train  # noqa: E402
from test_torch_train_model import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(dtype="float32", param_dtype="float32")


def test_loss_decreases_dense():
    cfg = get_config("qwen3_8b").reduced(layers=2, d_model=128).with_(
        vocab_size=256, **F32)
    _, _, hist = train(cfg, steps=30, opt=AdamWConfig(lr=3e-3,
                                                      warmup_steps=5),
                       batch_size=8, seq_len=64, log_every=1, device="cpu")
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first * 0.9, (first, last)


def test_loss_decreases_moe():
    cfg = get_config("phi3_5_moe_42b").reduced(layers=2, d_model=128).with_(
        vocab_size=256, **F32)
    _, _, hist = train(cfg, steps=25, opt=AdamWConfig(lr=3e-3,
                                                      warmup_steps=5),
                       batch_size=8, seq_len=64, log_every=1, device="cpu")
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert all(h["aux"] > 0 for h in hist)


def test_checkpoint_roundtrip(tmp_path):
    cfg = get_config("stablelm_12b").reduced(layers=2, d_model=128).with_(
        param_dtype="float32", vocab_size=128)
    params = model.init(cfg, torch.Generator().manual_seed(0), "cpu")
    path = os.path.join(tmp_path, "ckpt.msgpack")
    checkpoint.save(path, params, meta={"step": np.asarray(7)})
    loaded = checkpoint.load(path)
    assert int(loaded["__meta__"]["step"]) == 7
    assert set(loaded["params"]) == set(params)
    for k, v in params.items():
        assert torch.equal(v, loaded["params"][k])


def test_bf16_optimizer_states():
    cfg = get_config("xlstm_125m").reduced(layers=2, d_model=128).with_(
        vocab_size=128, **F32)
    _, opt_state, hist = train(
        cfg, steps=6, opt=AdamWConfig(lr=1e-3, state_dtype="bfloat16"),
        batch_size=4, seq_len=32, log_every=1, device="cpu")
    leaf = next(iter(opt_state["m"].values()))
    assert leaf.dtype == torch.bfloat16
    assert int(opt_state["step"]) == 6
    assert np.isfinite(hist[-1]["loss"])


def test_launcher_trains_reduced_on_the_cpu(tmp_path):
    path = tmp_path / "ckpt.msgpack"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-8b", "--reduced", "--steps", "3", "--device", "cpu",
         "--save", str(path)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "step     2 loss=" in out.stdout
    assert int(checkpoint.load(str(path))["__meta__"]["step"]) == 3


def test_launcher_refuses_a_mesh():
    """A mesh above 1x1 needs one process a rank (``torchrun``); started
    alone, the launcher refuses it and names the command."""
    for axis in ("--data-axis", "--model-axis"):
        with pytest.raises(RuntimeError, match="torchrun"):
            launch_train.main(["--arch", "qwen3-8b", "--reduced", axis, "2",
                               "--device", "cpu"])


def test_train_runs_on_the_card_by_default():
    """Without ``device`` the loop asks for the card; with none present
    that fails rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_config("qwen3_8b").reduced(layers=1).with_(**F32)
    with pytest.raises(RuntimeError):
        train(cfg, steps=1, batch_size=1, seq_len=8)
