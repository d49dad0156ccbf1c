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
from repro_torch.models import model, moe  # noqa: E402
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


MB = 16     # decode calls of 16 rows: the capacity of 8 an expert binds


def _wide_workload(G, S, vocab):
    """18 greedy requests of 20-60 prompt tokens (so that no prefill call
    is as short as a decode call) and 12-24 outputs: 16 rows decode
    together."""
    rng = np.random.default_rng(23)
    return [G(prompt=[int(t) for t in rng.integers(
        0, vocab, int(rng.integers(20, 61)))],
        params=S(max_new_tokens=int(rng.integers(12, 25))))
        for _ in range(18)]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_drops(cfgs, ecfg, monkeypatch):
    """The 16-row drop workload on ``cfgs`` (at ``capacity_factor=0.5``)
    against the reference engine: the streams, completion times, decisions
    and counters equal, 16 rows decoded together, and decode calls did
    drop (counted by a wrapper of ``moe._route`` inside
    ``model.decode_pieces``, the decode step of both decode paths).
    Returns the port's engine."""
    drops, in_decode, widest = [], [], [0]
    route, pieces = moe._route, model.decode_pieces

    def decoding(*a, **kw):
        widest[0] = max(widest[0], int(kw["active"].sum()))
        in_decode.append(True)
        try:
            return (yield from pieces(*a, **kw))
        finally:
            in_decode.pop()

    def counted(xf, router, k, E, Cl):
        out = route(xf, router, k, E, Cl)
        if in_decode:
            assert xf.shape[0] * xf.shape[1] == MB
            drops.append(int((~out[3]).sum()))
        return out

    monkeypatch.setattr(model, "decode_pieces", decoding)
    monkeypatch.setattr(moe, "_route", counted)
    scfg = dict(kvc_tokens=MB * 128, block_size=16, tfs=256,
                max_model_len=128, max_batch_reqs=MB)
    pair = _run_pair(cfgs, _wide_workload, ecfg=ecfg, scfg=scfg, mb=MB,
                     cap=128)
    eng = _equal(pair)
    assert moe.capacity(eng.cfg, MB) == 8 and widest[0] == MB
    assert drops and sum(drops) > 0, drops
    assert len(drops) == eng.decode_iters * eng.cfg.num_layers
    if ecfg is None:
        assert eng.n_mega_windows > 0
    return eng


@pytest.mark.parametrize("ecfg", [None, LEGACY], ids=["megastep", "legacy"])
def test_moe_decode_drops_like_the_reference(ecfg, one_thread, monkeypatch):
    """``max_batch=16`` at ``capacity_factor=0.5``: a decode call routes
    16 tokens (inactive rows too, as the reference's) to 2 of 4 experts
    with ``capacity(16) = 8`` slots each, so an expert chosen by more than
    8 rows drops the rest. The streams, completion times, decisions and
    counters equal the reference engine's, under megastep windows and
    under the legacy sync decode; 16 rows decoded together, and decode
    calls did drop."""
    run_drops(_cfgs(capacity_factor=0.5), ecfg, monkeypatch)
