"""The port's engine on a sliding-window stack (mistral-nemo-12b reduced,
window 64) held against ``repro.serving.ServingEngine`` on the same
weights and requests, in float32: greedy streams, completion times,
scheduler decisions, ``sync_counts`` and the dispatch counters equal.

With a capacity of at least the window the attention caches are rings of
64 slots: prompts longer than the window seed only their last 64 tokens
(token p at slot p mod 64), decode wraps around the ring, chunks recompute
their prefix, and no KV image leaves the engine. With a capacity below the
window the caches are ordinary rows: chunks attend over the seeded prefix
and KV images migrate. The fleets are held against the JAX fleet."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.config import ATTN  # noqa: E402
from repro_torch.models.weights import params_from_jax  # noqa: E402

from test_torch_cluster import (Backend, assert_parity,  # noqa: E402
                                fleet_summary)
from test_torch_engine import _fingerprint, _run_pair  # noqa: E402

F32 = dict(dtype="float32", param_dtype="float32")
WIN = 64
ARCH = "mistral_nemo_12b"


def _cfg(port: bool, layers: int = 2):
    return (get_config if port else jax_config)(ARCH).reduced(
        layers=layers).with_(sliding_window=WIN, **F32)


def _scfg(tfs, mb, cap):
    return dict(kvc_tokens=mb * cap, block_size=16, tfs=tfs,
                max_model_len=cap, max_batch_reqs=mb)


def _long_prompts(lens, outs, seed=0):
    """Prompts of ``lens`` tokens with ``outs`` greedy outputs each."""
    def make(G, S, vocab):
        rng = np.random.default_rng(seed)
        return [G(prompt=[int(t) for t in rng.integers(0, vocab, L)],
                  params=S(max_new_tokens=n)) for L, n in zip(lens, outs)]
    return make


def _equal(pair):
    (jeng, jreqs), (eng, reqs) = pair
    for g in reqs:
        assert g.status == "completed"
        assert len(g.output) == g.params.max_new_tokens
    assert _fingerprint(eng, reqs) == _fingerprint(jeng, jreqs)
    assert eng.can_migrate_kv == jeng.can_migrate_kv
    return eng, reqs


@pytest.mark.parametrize("ecfg", [None, dict(async_decode=False,
                                             packed_prefill=False)],
                         ids=["default", "legacy"])
def test_ring_caches_match_jax(ecfg):
    """Capacity 192 over a window of 64: prompts of 70-150 tokens under a
    96-token prefill budget (packed waves of whole prompts and recomputed
    chunks), 20-40 outputs each, so every row wraps its ring."""
    wl = _long_prompts((150, 70, 110, 40, 90), (20, 40, 24, 30, 28))
    eng, reqs = _equal(_run_pair((_cfg(False), _cfg(True)), wl,
                                 scfg=_scfg(96, 4, 192), mb=4, cap=192,
                                 ecfg=ecfg))
    assert eng.caches[ATTN]["k"].shape[2] == WIN
    assert eng._is_ring(ATTN) and not eng.can_migrate_kv
    assert not eng._chunk_incremental and not eng._chunk_packed
    assert eng.n_prefill_chunks >= 2
    assert max(len(g.prompt) + len(g.output) for g in reqs) > 2 * WIN
    if ecfg is None:
        assert eng.n_mega_windows > 0


def test_capacity_below_the_window_keeps_the_prefix_paths():
    """Capacity 48 under a window of 64: ordinary rows, incremental and
    packed chunk waves, and a portable KV image."""
    wl = _long_prompts((40, 30, 25, 9), (6, 8, 5, 7), seed=1)
    eng, _ = _equal(_run_pair((_cfg(False), _cfg(True)), wl,
                              scfg=_scfg(16, 4, 48), mb=4, cap=48))
    assert eng.caches[ATTN]["k"].shape[2] == 48 and not eng._is_ring(ATTN)
    assert eng.can_migrate_kv and eng._chunk_incremental
    assert eng.max_chunk_items_per_call >= 2


class WindowBackend(Backend):
    """``test_torch_cluster.Backend`` on mistral-nemo-12b reduced to one
    layer, window 64."""

    def __init__(self, port: bool):
        super().__init__(port)
        self.cfg = _cfg(port, layers=1)

    def params(self, seed: int):
        if seed not in self._params:
            flat = jmodel.init(_cfg(False, layers=1), jax.random.PRNGKey(seed))
            self._params[seed] = params_from_jax(
                {k: np.asarray(v) for k, v in flat.items()}, device="cpu",
                dtype=torch.float32)
        return self._params[seed]

    def long_reqs(self, n=4, seed=3):
        rng = np.random.default_rng(seed)
        return [self.GenRequest(
            prompt=[int(t) for t in rng.integers(
                0, self.cfg.vocab_size, int(rng.integers(60, 120)))],
            params=self.SamplingParams(
                max_new_tokens=int(rng.integers(8, 30)), temperature=0.0))
            for _ in range(n)]


@pytest.mark.parametrize("cap", [160, 48], ids=["ring", "below-window"])
def test_window_fleet_matches_jax(cap):
    """A prefill + decode fleet: with rings every migration falls back to
    recompute; below the window the KV images move. Either way the
    streams equal the JAX fleet's and one engine's."""
    def run(B):
        fleet = B.fleet(2, roles=("prefill", "decode"), router="least-kvc",
                        max_batch=4, capacity=cap, rl_accuracy=1.0)
        ref = B.engine(params=fleet.params, max_batch=4, capacity=cap,
                       rl_accuracy=1.0)
        mk = (B.long_reqs if cap > WIN else B.reqs)
        ref_reqs = mk(n=4)
        ref.run(ref_reqs)
        out = fleet_summary(fleet, fleet.run(mk(n=4)))
        out["ref_streams"] = [list(g.output) for g in ref_reqs]
        out["can_migrate"] = [i.engine.can_migrate_kv
                              for i in fleet.instances]
        return out
    s = assert_parity(run, (WindowBackend(False), WindowBackend(True)))
    assert s["streams"] == s["ref_streams"]
    assert s["conservation"]["ok"]
    ring = cap > WIN
    assert s["can_migrate"] == [not ring, not ring]
    c = s["counters"]
    assert c["n_migrations"] == 4
    assert c["n_kv_fallbacks"] == (4 if ring else 0)
