"""Fleets of hybrid (zamba2-7b reduced) engines held against the JAX
fleet on the same weights and requests, in float32 (the scenarios of
``test_torch_cluster.py`` on a stack with no portable KV image)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402

from test_torch_cluster import (assert_parity, fleet_summary,  # noqa: E402
                                Backend)

F32 = dict(dtype="float32", param_dtype="float32")


def _cfg(port: bool):
    return (get_config if port else jax_config)("zamba2_7b").reduced().with_(
        **F32)


class HybridBackend(Backend):
    """``test_torch_cluster.Backend`` on zamba2-7b reduced."""

    def __init__(self, port: bool):
        super().__init__(port)
        self.cfg = _cfg(port)

    def params(self, seed: int):
        if seed not in self._params:
            flat = jmodel.init(_cfg(False), jax.random.PRNGKey(seed))
            self._params[seed] = params_from_jax(
                {k: np.asarray(v) for k, v in flat.items()}, device="cpu",
                dtype=torch.float32)
        return self._params[seed]


@pytest.mark.parametrize("roles", [None, ("prefill", "decode")],
                         ids=["unified", "disagg"])
def test_zamba2_fleet_matches_jax(roles):
    """A 2-instance fleet of zamba2 engines, unified or prefill + decode.
    Disaggregated, a hybrid stack has no portable KV image, so every
    migration is a recompute reseed on the decode engine, as in the JAX
    fleet; the streams equal one engine's either way."""
    def run(B):
        fleet = B.fleet(2, roles=roles, router="least-kvc", max_batch=4,
                        capacity=128, rl_accuracy=1.0)
        ref = B.engine(params=fleet.params, max_batch=4, capacity=128,
                       rl_accuracy=1.0)
        ref_reqs = B.reqs(n=4)
        ref.run(ref_reqs)
        out = fleet_summary(fleet, fleet.run(B.reqs(n=4)))
        out["ref_streams"] = [list(g.output) for g in ref_reqs]
        out["can_migrate"] = [i.engine.can_migrate_kv
                              for i in fleet.instances]
        return out
    s = assert_parity(run, (HybridBackend(False), HybridBackend(True)))
    assert s["streams"] == s["ref_streams"]
    assert s["can_migrate"] == [False, False]
    assert s["conservation"]["ok"]
    c = s["counters"]
    want = 0 if roles is None else 4
    assert c["n_migrations"] == c["n_kv_fallbacks"] == want
