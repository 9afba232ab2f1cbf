"""The port's ``TopicServer`` against the reference's, and the model it
serves.

* The reference's serving cases (malformed requests answered without
  spoiling their tick, a transactional refresh, the LM engine's validation)
  run on the port on the CPU.
* Both servers answer the same requests over one model (fitted by the
  reference, carried by ``convert.estimator_from_reference``): the same
  rejected set, the same topic ids, loadings within 1e-4; a refresh moves
  both U alike (1e-4).  The port runs ``torch-csr`` and ``cuda-bsr`` (its
  kernels' plain versions here).
* ``estimator_from_reference`` carries the streaming statistics, so a
  ``partial_fit`` continues the reference's stream.
* ``transform``'s epilogue goes through ``relu_topk`` and is bitwise the
  unfused relu + bisection.
"""
import copy
import math
import warnings

import numpy as np
import pytest
import torch

from repro.nmf import EnforcedNMF as RefNMF
from repro.nmf import NMFConfig as RefConfig
from repro.serving.topics import TopicRequest as RefRequest
from repro.serving.topics import TopicServer as RefServer
from repro_torch.convert import estimator_from_reference
from repro_torch.core import topk
from repro_torch.core.nmf import _matmul_t, solve_gram
from repro_torch.nmf import EnforcedNMF, NMFConfig, Sparsity
from repro_torch.serving import TopicRequest, TopicServer

K = 4
TOL = 1e-4


@pytest.fixture(scope="module")
def docs():
    rng = np.random.default_rng(0)
    return np.abs(rng.normal(size=(16, 48))).astype(np.float32)


@pytest.fixture(scope="module")
def topic_model(docs):
    return EnforcedNMF(NMFConfig(k=K, iters=10, seed=1), device="cpu").fit(
        docs)


@pytest.fixture(scope="module")
def ref_model(docs):
    return RefNMF(RefConfig(k=K, iters=10, seed=1)).fit(docs)


def _port_model(ref, backend=None, stats=True):
    """The reference model's state in a port estimator on the CPU."""
    cfg = NMFConfig(k=K, iters=10, seed=1, backend=backend)
    kw = {}
    if stats:
        kw = dict(av=np.asarray(ref._av_acc), gv=np.asarray(ref._gv_acc),
                  n_docs_seen=ref.n_docs_seen_)
    return estimator_from_reference(np.asarray(ref.u_), np.asarray(ref.v_),
                                    ref._m_ref, cfg, device="cpu", **kw)


def _requests(n_terms, n=37, seed=7):
    """Bag-of-words requests, and five malformed ones among them."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        terms = rng.choice(n_terms, size=int(rng.integers(1, 6)),
                           replace=False)
        out.append((rid, [(int(t), float(w)) for t, w in
                          zip(terms, 3.0 * rng.random(len(terms)))]))
    out[5:5] = [(100, []), (101, [(3, float("nan"))]), (102, "not-pairs"),
                (103, [(999, 1.0)]), (104, [(2, 1.0), (-1, 2.0)])]
    return out


def _serve(server, request_cls, reqs):
    for rid, terms in reqs:
        server.submit(request_cls(rid=rid, terms=terms, top=K))
    return {r.rid: r for r in server.run_until_drained()}


def _assert_same_picks(got, want, tol=TOL):
    """Loadings within ``tol`` (a topic missing on one side counts as 0),
    and topics whose loadings differ by more than ``tol`` in the same
    order."""
    g, w = dict(got), dict(want)
    for t in set(g) | set(w):
        assert abs(g.get(t, 0.0) - w.get(t, 0.0)) <= tol, (got, want)
    rank = {t: i for i, (t, _) in enumerate(got)}
    for a in w:
        for b in w:
            if w[a] - w[b] > tol and a in rank and b in rank:
                assert rank[a] < rank[b], (got, want)


# ---------------------------------------------------------------------------
# the reference's serving cases, on the port
# ---------------------------------------------------------------------------

def test_topic_server_rejects_malformed_docs_not_the_tick(topic_model):
    srv = TopicServer(topic_model, max_batch=8)
    srv.submit(TopicRequest(rid=0, terms=[(2, 1.0), (5, 2.0)]))
    srv.submit(TopicRequest(rid=1, terms=[(3, float("nan"))]))
    srv.submit(TopicRequest(rid=2, terms="not-pairs"))
    srv.submit(TopicRequest(rid=3, terms=[(999, 1.0)]))   # all out of vocab
    srv.submit(TopicRequest(rid=4, terms=[(7, 1.5)]))
    done = {r.rid: r for r in srv.run_until_drained()}
    assert sorted(done) == [0, 1, 2, 3, 4]
    assert done[0].error is None and done[0].topics
    assert done[4].error is None and done[4].topics
    for rid in (1, 2, 3):
        assert done[rid].error is not None and done[rid].topics == []
    assert srv.rejected == 3
    # rejected documents must not leak into the fold-in buffer
    assert len(srv._refresh_buf) == 2


def test_topic_refresh_rolls_back_on_unhealthy_update(topic_model):
    srv = TopicServer(topic_model, max_batch=8)
    srv.submit(TopicRequest(rid=0, terms=[(2, 1.0)]))
    srv.run_until_drained()
    u_before = topic_model.u_.clone()
    orig = topic_model.partial_fit

    def poisoned_fit(*args, **kwargs):
        orig(*args, **kwargs)
        topic_model.u_ = topic_model.u_ * float("nan")
        topic_model.health_ = torch.zeros((), dtype=torch.int32)

    topic_model.partial_fit = poisoned_fit
    try:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert srv.refresh() == 0
    finally:
        topic_model.partial_fit = orig
    assert srv.refresh_failures == 1
    assert any("rolled back" in str(x.message) for x in w)
    assert torch.equal(topic_model.u_, u_before)
    assert len(srv._refresh_buf) == 1   # re-buffered for the next attempt
    assert srv.refresh() == 1           # and the retry lands
    assert int(topic_model.health_) < 0


def test_topic_refresh_surfaces_a_failing_update(topic_model):
    """An update that raises (here a kernel's CUDA error) is rolled back
    and re-buffered, and the error propagates: it is never served around."""
    srv = TopicServer(topic_model, max_batch=8)
    srv.submit(TopicRequest(rid=0, terms=[(2, 1.0)]))
    srv.run_until_drained()
    u_before = topic_model.u_.clone()
    orig = topic_model.partial_fit

    def failing_fit(*args, **kwargs):
        orig(*args, **kwargs)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    topic_model.partial_fit = failing_fit
    try:
        with pytest.raises(RuntimeError, match="CUDA error"):
            srv.refresh()
    finally:
        topic_model.partial_fit = orig
    assert srv.refresh_failures == 1
    assert torch.equal(topic_model.u_, u_before)
    assert len(srv._refresh_buf) == 1   # re-buffered for the next attempt
    assert srv.refresh() == 1


def test_serving_engine_validation_rejects_without_model():
    from repro_torch.serving.engine import Request, ServingEngine

    class Shell(ServingEngine):
        """Validation only: no params, no cache, no decode."""

        def __init__(self):
            self.cfg = type("Cfg", (), {"vocab": 64})()
            self.max_batch = 4
            self.max_seq = 32
            self.slots = [None] * 4
            self.queue = []

    eng = Shell()
    bad = [Request(rid=1, prompt=[], max_new=3),
           Request(rid=2, prompt=[1, 999], max_new=3),
           Request(rid=3, prompt=[1, 2], max_new=0),
           Request(rid=4, prompt=[1, 2], max_new=64)]
    for r in bad:
        r.out = []
        eng.queue.append(r)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        eng._admit()
    assert all(r.error is not None for r in bad)
    assert all(s is None for s in eng.slots)
    assert len(w) == 4


def test_topic_server_needs_a_fitted_model():
    with pytest.raises(ValueError, match="fitted"):
        TopicServer(EnforcedNMF(NMFConfig(k=K), device="cpu"))


def test_automatic_refresh_and_tick_stats(topic_model):
    model = copy.copy(topic_model)
    srv = TopicServer(model, max_batch=4, refresh_every=6)
    reqs = _requests(16, n=9)
    _serve(srv, TopicRequest, reqs)
    assert srv.stats["ticks"] == math.ceil(len(reqs) / 4)
    assert srv.refreshed >= 6 and srv.refresh_failures == 0
    assert min(srv.stats[k] for k in ("pack_s", "ingest_s",
                                      "device_s")) >= 0.0
    assert topic_model.u_ is not model.u_      # the copy was refreshed


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", [None, "cuda-bsr"])
def test_topic_server_answers_like_the_reference(ref_model, backend):
    reqs = _requests(16)
    ref_srv = RefServer(copy.copy(ref_model), max_batch=8)
    srv = TopicServer(_port_model(ref_model, backend), max_batch=8)
    want = _serve(ref_srv, RefRequest, reqs)
    got = _serve(srv, TopicRequest, reqs)
    assert sorted(got) == sorted(want)
    rejected = {rid for rid, r in want.items() if r.error is not None}
    assert {rid for rid, r in got.items() if r.error is not None} == rejected
    assert rejected == {100, 101, 102, 103} and srv.rejected == 4
    for rid in want:
        _assert_same_picks(got[rid].topics, want[rid].topics)
    assert srv.stats["ticks"] == math.ceil(len(reqs) / 8)


@pytest.mark.parametrize("backend", [None, "cuda-bsr"])
def test_topic_refresh_moves_u_like_the_reference(ref_model, backend):
    reqs = _requests(16)
    ref = copy.copy(ref_model)
    port = _port_model(ref_model, backend)
    ref_srv, srv = RefServer(ref, max_batch=8), TopicServer(port, max_batch=8)
    _serve(ref_srv, RefRequest, reqs)
    _serve(srv, TopicRequest, reqs)
    assert srv.refresh() == ref_srv.refresh() == len(reqs) - 4
    np.testing.assert_allclose(port.u_.numpy(), np.asarray(ref.u_),
                               atol=TOL)
    assert int(port.health_) == -1
    assert port.n_docs_seen_ == ref.n_docs_seen_


def test_converted_model_continues_the_reference_stream(ref_model):
    """``estimator_from_reference`` carries ``_av_acc`` / ``_gv_acc`` /
    ``n_docs_seen_``: a ``partial_fit`` of one new chunk gives the
    reference's U.  Without the statistics the port's stream starts over
    and U parts from the reference's."""
    new = np.abs(np.random.default_rng(9).normal(size=(16, 12))).astype(
        np.float32)
    ref = copy.copy(ref_model)
    ref.partial_fit(new)
    port = _port_model(ref_model)
    port.partial_fit(new)
    np.testing.assert_allclose(port.u_.numpy(), np.asarray(ref.u_),
                               atol=TOL)
    assert port.n_docs_seen_ == ref.n_docs_seen_
    bare = _port_model(ref_model, stats=False)
    bare.partial_fit(new)
    assert not np.allclose(bare.u_.numpy(), np.asarray(ref.u_), atol=TOL)


def test_estimator_from_reference_takes_both_statistics(ref_model):
    with pytest.raises(ValueError, match="both"):
        estimator_from_reference(np.asarray(ref_model.u_),
                                 np.asarray(ref_model.v_), 48,
                                 NMFConfig(k=K), device="cpu",
                                 av=np.asarray(ref_model._av_acc))


# ---------------------------------------------------------------------------
# transform's epilogue through relu_topk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch-csr", "cuda-bsr", "torch-dense"])
def test_transform_epilogue_is_one_relu_topk_and_bitwise_unfused(
        docs, backend, monkeypatch):
    model = EnforcedNMF(NMFConfig(k=K, iters=10, seed=1, backend=backend,
                                  sparsity=Sparsity(t_v=40)),
                        device="cpu").fit(docs)
    new = np.abs(np.random.default_rng(4).normal(size=(16, 20))).astype(
        np.float32)
    calls = []
    real = topk.relu_topk
    monkeypatch.setattr(topk, "relu_topk",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    v = model.transform(new)
    assert len(calls) == 1
    a_new = model._coerce(new)
    u = model.u_
    raw = solve_gram(u.T @ u, _matmul_t(a_new, u))
    t = max(1, round(40 * 20 / 48))             # t_v rescaled to 20 docs
    want = topk.topk_project_bisect(torch.clamp_min(raw, 0.0), t)
    assert torch.equal(v.view(torch.int32), want.view(torch.int32))
