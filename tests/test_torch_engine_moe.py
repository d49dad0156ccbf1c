"""The port's engine on a MoE stack (phi3.5-MoE reduced) held against
``repro.serving.ServingEngine`` on the same weights and requests, in
float32: greedy streams, completion times, scheduler decisions,
``sync_counts``, the dispatch counters and the prefill call shapes equal.

A MoE's expert capacity grows with the call's token count, so the port
runs MoE stacks at the reference's padded shapes: packed waves, chunk
waves, single and recomputed chunks, and the legacy padded path (where pad
tokens sit between rows in the dispatch order). The ``capacity_factor=0.5``
runs drop tokens, and on exact-length calls their streams differ from the
reference's. The last test is a disaggregated fleet with KV migration
against the JAX fleet."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402

from test_torch_cluster import Backend, _disagg, assert_parity  # noqa: E402
from test_torch_engine import (_async_workload, _chunk_workload,  # noqa: E402
                               _fingerprint, _megastep_workload, _run_pair)

F32 = dict(dtype="float32", param_dtype="float32")
LEGACY = dict(async_decode=False, packed_prefill=False)
ARCH = "phi3_5_moe_42b"


def _cfgs(**over):
    return (jax_config(ARCH).reduced().with_(**F32, **over),
            get_config(ARCH).reduced().with_(**F32, **over))


def _chunk_scfg():
    return dict(kvc_tokens=4 * 192, block_size=16, tfs=32,
                max_model_len=192, max_batch_reqs=4)


def _equal(pair):
    (jeng, jreqs), (eng, reqs) = pair
    for g in reqs:
        assert g.status == "completed"
        assert len(g.output) == g.params.max_new_tokens
    assert _fingerprint(eng, reqs) == _fingerprint(jeng, jreqs)
    assert eng._prefill_shapes == jeng._prefill_shapes
    return eng


def _odd_wave(G, S, vocab):
    """Four prompts of 65 tokens in all: one packed wave padded to 128,
    where an exact-length call would get half the expert capacity."""
    rng = np.random.default_rng(11)
    return [G(prompt=[int(t) for t in rng.integers(0, vocab, L)],
              params=S(max_new_tokens=10)) for L in (30, 20, 9, 6)]


def test_moe_megastep_windows():
    eng = _equal(_run_pair(_cfgs(), _megastep_workload))
    assert eng.n_mega_windows > 0
    assert all(b == 1 and t & (t - 1) == 0 for b, t in eng._prefill_shapes)


def test_moe_legacy_padded_prefill_and_sync_decode():
    """``packed_prefill=False``: (max_batch, seq_bucket) calls whose pad
    tokens sit between rows in the dispatch order."""
    eng = _equal(_run_pair(_cfgs(), _async_workload, ecfg=LEGACY))
    assert {b for b, _ in eng._prefill_shapes} == {eng.max_batch}


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "per-chunk"])
def test_moe_chunk_waves(packed):
    eng = _equal(_run_pair(
        _cfgs(), _chunk_workload, scfg=_chunk_scfg(), cap=192,
        ecfg=None if packed else dict(packed_chunk_prefill=False)))
    assert eng.n_chunk_calls > 0 and eng.n_prefill_chunks >= 2
    if packed:
        assert eng.max_chunk_items_per_call >= 2


@pytest.mark.parametrize("path", ["wave", "chunks", "recompute", "legacy"])
def test_moe_capacity_factor_half_drops_like_the_reference(path):
    """At ``capacity_factor=0.5`` the expert capacity binds: every call
    drops tokens, and how many depends on the call's padded length."""
    cfgs = _cfgs(capacity_factor=0.5)
    if path == "wave":
        pair = _run_pair(cfgs, _odd_wave)
    elif path == "legacy":
        pair = _run_pair(cfgs, _odd_wave, ecfg=LEGACY)
    else:
        pair = _run_pair(cfgs, _chunk_workload, scfg=_chunk_scfg(), cap=192,
                         ecfg=None if path == "chunks"
                         else dict(incremental_chunk_prefill=False))
    eng = _equal(pair)
    if path in ("chunks", "recompute"):
        assert eng.n_prefill_chunks >= 2
        assert eng._chunk_incremental == (path == "chunks")


class MoEBackend(Backend):
    """``test_torch_cluster.Backend`` on phi3.5-MoE reduced to one layer."""

    def __init__(self, port: bool):
        super().__init__(port)
        self.cfg = (get_config if port else jax_config)(ARCH).reduced(
            layers=1).with_(**F32)

    def params(self, seed: int):
        if seed not in self._params:
            flat = jmodel.init(jax_config(ARCH).reduced(layers=1).with_(
                **F32), jax.random.PRNGKey(seed))
            self._params[seed] = params_from_jax(
                {k: np.asarray(v) for k, v in flat.items()}, device="cpu",
                dtype=torch.float32)
        return self._params[seed]


def test_moe_fleet_kv_migration_matches_jax():
    """Prefill -> decode migration of MoE engines: every request moves with
    its KV image and the streams equal the JAX fleet's and one engine's."""
    s = assert_parity(_disagg(True, "least-kvc"),
                      (MoEBackend(False), MoEBackend(True)))
    assert s["streams"] == s["ref_streams"]
    c = s["counters"]
    assert s["conservation"]["ok"] and c["n_migrations"] == 6
    assert c["n_kv_fallbacks"] == 0
