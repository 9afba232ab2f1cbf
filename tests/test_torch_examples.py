"""Port parity for the NMF examples:
``examples/torch_topic_modeling_pipeline.py`` and
``examples/torch_quickstart.py`` against the reference's
``examples/topic_modeling_pipeline.py`` and ``examples/quickstart.py``.

* Batch mode: one ``factors.npz`` of a seeded numpy U and V is written into
  two directories; the reference's own ``main`` (through ``runpy``) and the
  port's ``main(..., "--device", "cpu")`` both resume from it.  The two
  final checkpoints agree within 1e-4 (the reference's end-to-end bar,
  ``tests/test_backends.py:365-380``), NNZ up to ties, and the printed
  accuracy, stored NNZ and serving counts are equal.
* ``--stream`` and stages 4-5: the port's stage functions from one explicit
  first U against the reference's modules called in the reference
  example's order: U, V and ``n_docs_seen_`` after each chunk, the fold-in,
  each served request's topic and the refresh, within 1e-4.
* The quickstart prints every line the reference's prints, label for label.

The port runs ``cuda-bsr`` with its kernels' plain versions here; the
reference its example's ``jnp-csr``.
"""
import contextlib
import importlib.util
import io
import re
import runpy
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nmf import EnforcedNMF as RefNMF
from repro.nmf import NMFConfig as RefConfig
from repro.nmf import Sparsity as RefSparsity
from repro.serving import TopicRequest as RefRequest
from repro.serving import TopicServer as RefServer
from repro.sparse import from_scipy as ref_from_scipy
from repro.sparse import to_dense as ref_to_dense
from repro_torch.checkpoint import save_nmf_factors_sparse
from repro_torch.kernels import _build
from repro_torch.nmf import EnforcedNMF

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples"
TOL = 1e-4
SMALL = ["--terms", "1000", "--docs", "400", "--iters", "40", "--rounds",
         "2"]


def load_example(name):
    """An example script as a module (``examples/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_reference(script, argv):
    """The reference example ``script`` run as ``__main__`` with
    ``argv``; its standard output."""
    out = io.StringIO()
    saved = sys.argv
    sys.argv = [str(EXAMPLES / script)] + list(argv)
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(EXAMPLES / script), run_name="__main__")
    finally:
        sys.argv = saved
    return out.getvalue()


def run_port(fn, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = fn(argv)
    return got, out.getvalue()


@pytest.fixture(scope="module")
def pipeline():
    return load_example("torch_topic_modeling_pipeline")


# ---------------------------------------------------------------------------
# batch mode: both examples' own main, resumed from one checkpoint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def batch_runs(pipeline, tmp_path_factory):
    rng = np.random.default_rng(3)
    u = rng.random((1000, 5)).astype(np.float32)
    v = rng.random((400, 5)).astype(np.float32)
    dirs = {side: tmp_path_factory.mktemp(f"ckpt-{side}")
            for side in ("ref", "port")}
    for d in dirs.values():
        save_nmf_factors_sparse(str(d / "factors.npz"), u, v)
    ref_out = run_reference("topic_modeling_pipeline.py",
                            SMALL + ["--ckpt", str(dirs["ref"])])
    _build.reset_launch_counts()
    got, port_out = run_port(pipeline.main, SMALL + [
        "--ckpt", str(dirs["port"]), "--device", "cpu"])
    launches = _build.launch_counts()
    factors = {side: np.load(d / "factors.npz") for side, d in dirs.items()}
    return dict(ref=ref_out, port=port_out, got=got, factors=factors,
                launches=launches)


def _dense(npz, name):
    shape = tuple(int(s) for s in npz[f"{name}_shape"])
    flat = np.zeros(int(np.prod(shape)), np.float32)
    flat[npz[f"{name}_idx"]] = npz[f"{name}_val"]
    return flat.reshape(shape)


def _ref_number(text, pattern):
    m = re.search(pattern, text)
    assert m is not None, (pattern, text)
    return m.group(1)


@pytest.mark.parametrize("factor", ["u", "v"])
def test_batch_checkpoints_match_the_reference_example(batch_runs, factor):
    """The two final ``factors.npz``: the factor within 1e-4, its NNZ up to
    ties at the top-t threshold."""
    got = _dense(batch_runs["factors"]["port"], factor)
    want = _dense(batch_runs["factors"]["ref"], factor)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL)
    n_got, n_want = int((got != 0).sum()), int((want != 0).sum())
    assert abs(n_got - n_want) <= max(2, n_want // 100), (n_got, n_want)


@pytest.mark.parametrize("line,pattern,key", [
    ("nnz", r"nnz=(\d+)", lambda g: g["nnz"]),
    ("accuracy", r"clustering accuracy \(Eq\. 3\.3\): (\S+)",
     lambda g: f"{g['accuracy']:.3f}"),
    ("stored", r"stored NNZ (\d+)", lambda g: g["stored"]),
    ("dense", r"vs dense (\d+)", lambda g: g["dense"]),
    ("served", r"served (\d+) docs", lambda g: g["served"]),
    ("hits", r"(\d+)/\d+ documents assigned", lambda g: g["hits"]),
    ("folded", r"folded (\d+) served", lambda g: g["refresh"]["folded"]),
    ("docs seen", r"total docs seen: (\d+)",
     lambda g: g["refresh"]["docs_seen"]),
])
def test_batch_lines_match_the_reference_example(batch_runs, line, pattern,
                                                 key):
    got = batch_runs["got"]
    assert str(key(got)) == _ref_number(batch_runs["ref"], pattern), line
    assert re.search(pattern, batch_runs["port"]) is not None, line


def test_batch_rounds_resume_and_match_the_reference_example(batch_runs):
    """Both resume from the checkpoint; each round's printed error and
    NNZ(U) agree (NNZ up to ties)."""
    ref, got = batch_runs["ref"], batch_runs["got"]
    assert got["resumed"] and "resuming from" in ref
    assert "resuming from" in batch_runs["port"]
    want = re.findall(r"err=(\S+) resid=\S+ nnz\(U\)=(\d+)", ref)
    assert len(want) == len(got["rounds"]) == 2
    for rec, (err, nnz) in zip(got["rounds"], want):
        assert abs(rec["err"] - float(err)) <= 1e-4 + 5e-5
        assert abs(rec["nnz_u"] - int(nnz)) <= 2
    # on the CPU the wrappers run their plain versions and count nothing
    assert sum(batch_runs["launches"].values()) == 0


def test_batch_prints_the_reference_stages_in_order(batch_runs):
    stages = lambda text: re.findall(r"== (stage \d): ", text)
    assert stages(batch_runs["port"]) == stages(batch_runs["ref"]) == [
        f"stage {i}" for i in range(1, 6)]


# ---------------------------------------------------------------------------
# --stream and stages 4-5: the stage functions against the reference's
# modules in the reference example's order, from one first U
# ---------------------------------------------------------------------------

TERMS, DOCS, TOPICS, ITERS, ROUNDS = 1000, 400, 5, 40, 2


@pytest.fixture(scope="module")
def stream_runs(pipeline):
    args = pipeline.parse_args(SMALL + ["--device", "cpu"])
    u0 = np.random.default_rng(4).random((TERMS, TOPICS)).astype(np.float32)
    a_sp, dj, _ = pipeline.make_corpus(TERMS, DOCS, TOPICS)
    model = EnforcedNMF(pipeline.make_config(args), device="cpu")
    port_chunks = []

    def keep(i, m):
        port_chunks.append((m.u_.numpy().copy(), m.v_.numpy().copy(),
                            m.n_docs_seen_))

    with contextlib.redirect_stdout(io.StringIO()):
        pipeline.stream_fit(model, a_sp, ROUNDS, u0=u0, on_chunk=keep)
    op = pipeline.ingest(a_sp, "cpu")
    v_full = model.transform(op)

    ref = RefNMF(RefConfig(k=TOPICS, iters=ITERS // ROUNDS,
                           sparsity=RefSparsity(t_u=args.t_u, t_v=args.t_v)))
    ref.u_, ref.n_features_ = jnp.asarray(u0), TERMS
    a_cols = a_sp.tocsc()
    chunk_w = -(-DOCS // (2 * ROUNDS))
    ref_chunks = []
    for i in range(2 * ROUNDS):
        ref.partial_fit(ref_from_scipy(
            a_cols[:, i * chunk_w:min((i + 1) * chunk_w, DOCS)]))
        ref_chunks.append((np.asarray(ref.u_), np.asarray(ref.v_),
                           ref.n_docs_seen_))
    ref_v_full = np.asarray(ref.transform(ref_from_scipy(a_sp)))
    return dict(model=model, ref=ref, port_chunks=port_chunks,
                ref_chunks=ref_chunks, v_full=v_full.numpy(),
                ref_v_full=ref_v_full, dj=dj, a_sp=a_sp)


@pytest.mark.parametrize("chunk", range(2 * ROUNDS))
def test_stream_chunk_matches_reference(stream_runs, chunk):
    (u, v, seen), (ru, rv, rseen) = (stream_runs["port_chunks"][chunk],
                                     stream_runs["ref_chunks"][chunk])
    np.testing.assert_allclose(u, ru, atol=TOL)
    np.testing.assert_allclose(v, rv, atol=TOL)
    assert seen == rseen == (chunk + 1) * DOCS // (2 * ROUNDS)


def test_stream_fold_in_and_evaluation_match_reference(stream_runs,
                                                       pipeline):
    np.testing.assert_allclose(stream_runs["v_full"],
                               stream_runs["ref_v_full"], atol=TOL)
    with contextlib.redirect_stdout(io.StringIO()):
        got = pipeline.evaluate(stream_runs["model"],
                                torch.from_numpy(stream_runs["v_full"]),
                                stream_runs["dj"], TOPICS)
    want_stored = int(np.sum(np.asarray(stream_runs["ref"].u_) != 0)
                      + np.sum(stream_runs["ref_v_full"] != 0))
    assert abs(got["stored"] - want_stored) <= 2
    assert got["dense"] == (TERMS + DOCS) * TOPICS


@pytest.fixture(scope="module")
def serving_runs(stream_runs, pipeline):
    """Stage 4 on both models after the stream, then stage 5."""
    a_new, _, _ = pipeline.make_corpus(TERMS, pipeline.NEW_DOCS, TOPICS,
                                       seed=pipeline.NEW_SEED)
    reqs = pipeline.requests_for(a_new)
    # the reference example's requests, built from a dense copy
    dense = jnp.asarray(ref_to_dense(ref_from_scipy(a_new)))
    ref_reqs = []
    for rid in range(a_new.shape[1]):
        col = dense[:, rid]
        ref_reqs.append(RefRequest(rid=rid, terms=[
            (int(i), float(col[i])) for i in jnp.nonzero(col)[0]], top=1))
    ref_server = RefServer(stream_runs["ref"], max_batch=16)
    for req in ref_reqs:
        ref_server.submit(req)
    ref_done = ref_server.run_until_drained()
    # the reference's loadings of each tick's documents, for the margins
    cols = a_new.tocsc()
    ref_v = np.concatenate([np.asarray(stream_runs["ref"].transform(
        ref_from_scipy(cols[:, lo:lo + 16]))) for lo in range(0, 64, 16)])
    with contextlib.redirect_stdout(io.StringIO()):
        server, done, served = pipeline.serve(stream_runs["model"], reqs)
        got_refresh = pipeline.refresh(server)
    ref_folded = ref_server.refresh()
    return dict(reqs=reqs, ref_reqs=ref_reqs, done=done, ref_done=ref_done,
                served=served, ref_served=ref_server.served, ref_v=ref_v,
                refresh=got_refresh, ref_folded=ref_folded)


def test_requests_are_the_reference_examples_pairs(serving_runs):
    assert [r.terms for r in serving_runs["reqs"]] == \
        [r.terms for r in serving_runs["ref_reqs"]]


def test_served_topics_match_reference(serving_runs):
    """Each request's topic: the reference's argmax wherever its top-2
    margin is over 1e-4 (else a near-tie), the loading within 1e-4."""
    done, ref_done = serving_runs["done"], serving_runs["ref_done"]
    assert [r.rid for r in done] == [r.rid for r in ref_done]
    assert serving_runs["served"]["served"] == serving_runs["ref_served"]
    assert serving_runs["served"]["hits"] == sum(1 for r in ref_done
                                                 if r.topics)
    compared = 0
    for got, want in zip(done, ref_done):
        top2 = np.sort(serving_runs["ref_v"][want.rid])[-2:]
        if top2[1] - top2[0] <= 1e-4:
            continue
        assert got.topics[0][0] == want.topics[0][0], want.rid
        assert abs(got.topics[0][1] - want.topics[0][1]) <= TOL
        compared += 1
    assert compared >= 0.75 * len(done)


def test_refresh_matches_reference(serving_runs, stream_runs):
    assert serving_runs["refresh"]["folded"] == serving_runs["ref_folded"] \
        == 64
    assert serving_runs["refresh"]["docs_seen"] == \
        stream_runs["ref"].n_docs_seen_ == DOCS + 64
    np.testing.assert_allclose(stream_runs["model"].u_.numpy(),
                               np.asarray(stream_runs["ref"].u_), atol=TOL)


def test_stream_main_runs_every_stage(pipeline, tmp_path):
    """``--stream`` through ``main``: 4 chunks, a checkpoint, every request
    answered and folded back."""
    got, text = run_port(pipeline.main, SMALL + [
        "--stream", "--ckpt", str(tmp_path), "--device", "cpu"])
    assert [c["seen"] for c in got["chunks"]] == [100, 200, 300, 400]
    assert (tmp_path / "factors.npz").exists() and "ckpt=" in text
    assert got["served"] == got["answered"] == 64
    assert got["refresh"]["folded"] == 64
    assert re.findall(r"== (stage \d): ", text) == [
        f"stage {i}" for i in range(1, 6)]


# ---------------------------------------------------------------------------
# the quickstart
# ---------------------------------------------------------------------------

QUICKSTART_LABELS = [
    "term/document matrix:", "final relative error  :",
    "final residual        :", "NNZ(U)=", "clustering accuracy   :",
    "fold-in               :"] + [f"topic {i}: terms" for i in range(5)]


@pytest.fixture(scope="module")
def quickstart():
    ref = run_reference("quickstart.py", [])
    got, text = run_port(load_example("torch_quickstart").main,
                         ["--device", "cpu"])
    return ref.splitlines(), text.splitlines(), got


def test_quickstart_prints_every_reference_line(quickstart):
    ref_lines, _, _ = quickstart
    assert len(ref_lines) == len(QUICKSTART_LABELS)
    for line, label in zip(ref_lines, QUICKSTART_LABELS):
        assert line.startswith(label), (line, label)


@pytest.mark.parametrize("label", QUICKSTART_LABELS)
def test_quickstart_line_has_the_reference_label(quickstart, label):
    ref_lines, lines, got = quickstart
    want = [ln for ln in ref_lines if ln.startswith(label)]
    have = [ln for ln in lines if ln.startswith(label)]
    assert len(have) == len(want) == 1, (label, lines)
    if label.startswith("term/document"):
        assert have == want       # the corpus is bitwise the reference's
    if label.startswith("topic"):
        top, weights = got["topics"][int(label.split()[1][0])]
        assert len(top) == len(weights) == 5
        assert weights == sorted(weights, reverse=True)


def test_quickstart_names_its_device_and_returns_its_numbers(quickstart):
    _, lines, got = quickstart
    assert "device                : cpu" in lines
    assert np.isfinite(got["final_error"]) and np.isfinite(
        got["final_residual"])
    assert got["nnz_u"] <= 55 + 2 and len(got["fold_in"]) == 10
