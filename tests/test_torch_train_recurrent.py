"""``test_torch_train_model.py``'s parity for the recurrent and hybrid
families: the loss and every gradient of reduced zamba2 (Mamba2 layers and
two invocations of the shared attention block) and xlstm-125m (mLSTM and
sLSTM layers) against the reference's, float32, remat on both sides."""
import pytest

pytest.importorskip("torch")

from test_torch_train_model import (assert_close, both, cfgs,  # noqa: E402
                                    one_torch_thread)  # noqa: F401


@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_125m"])
def test_loss_and_every_grad_match_the_reference(arch):
    jcfg, cfg = cfgs(arch, dict(layers=4))
    assert_close(*both(jcfg, cfg, 2, 96))
