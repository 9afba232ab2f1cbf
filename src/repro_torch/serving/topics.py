"""Topic-inference serving endpoint over a fitted :class:`EnforcedNMF`
(port of ``repro.serving.topics``).

Requests carry a bag-of-words document (``(term_id, weight)`` pairs); the
server micro-batches them into one padded-CSR matrix per tick and folds the
batch into the fitted topic space with one frozen-``U`` ``transform``: on
``cuda-bsr`` one ``bsr_spmm`` launch for ``A^T U``, a (k x k) solve and one
``relu_topk`` launch for the epilogue, however many documents share the
tick.  The tick's loadings and topic order reach the host in one copy.

Served documents accumulate in a buffer, and :meth:`TopicServer.refresh`
folds them back into the model with one ``partial_fit`` (the online
statistics engine), as a transaction: an update that leaves the model
unhealthy is rolled back and the documents wait for the next refresh; one
that raises is rolled back too, and its exception propagates.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.sparse.csr import from_coo

__all__ = ["TopicRequest", "TopicServer"]


@dataclasses.dataclass
class TopicRequest:
    rid: int
    #: sparse bag-of-words: (term_id, weight) pairs
    terms: Sequence[Tuple[int, float]]
    #: how many top topics to return
    top: int = 3
    #: result: [(topic_id, loading), ...], strongest first
    topics: Optional[List[Tuple[int, float]]] = None
    #: set instead of ``topics`` when the request is malformed: it is
    #: answered, kept out of the refresh buffer, and the rest of its batch
    #: serves normally
    error: Optional[str] = None


class TopicServer:
    """Micro-batching fold-in server.

    >>> server = TopicServer(fitted_model, max_batch=32)
    >>> server.submit(TopicRequest(rid=0, terms=[(12, 2.0), (80, 1.0)]))
    >>> results = server.run_until_drained()
    >>> server.refresh()          # fold the served documents into the model

    ``refresh_every`` (documents) triggers :meth:`refresh` from inside
    :meth:`step`; ``None`` leaves it manual.  The buffer of served documents
    holds at most ``refresh_buffer`` of them (the oldest drop out).

    ``stats`` (host clock): ``ticks``; ``pack_s``, the term lists packed into
    padded CSR; ``ingest_s``, that matrix ingested for the model's backend
    and copied to its device; ``device_s``, the fold-in and the copy of its
    result to the host (on the card: the kernels and the one wait for
    them).
    """

    def __init__(self, estimator, max_batch: int = 32,
                 refresh_every: Optional[int] = None,
                 refresh_buffer: int = 4096):
        if getattr(estimator, "u_", None) is None:
            raise ValueError("TopicServer needs a fitted EnforcedNMF")
        self.estimator = estimator
        self.max_batch = max_batch
        self.n_terms = estimator.n_features_
        self.queue: List[TopicRequest] = []
        self.served = 0
        self.refresh_every = refresh_every
        self.refreshed = 0
        #: requests answered with an ``error`` instead of topics
        self.rejected = 0
        #: refresh attempts rolled back (an exception or unhealthy factors)
        self.refresh_failures = 0
        #: served documents awaiting the next refresh; an automatic refresh
        #: threshold implies at least that much buffer
        self._refresh_buf: Deque[Sequence[Tuple[int, float]]] = deque(
            maxlen=max(int(refresh_buffer), int(refresh_every or 0), 1))
        self.stats = {"ticks": 0, "pack_s": 0.0, "ingest_s": 0.0,
                      "device_s": 0.0}

    def submit(self, req: TopicRequest):
        self.queue.append(req)

    def _validate(self, req: TopicRequest) -> Optional[str]:
        """The request's rejection reason, or None when it is servable;
        checked per request, so one malformed document cannot spoil its
        batch."""
        try:
            pairs = list(req.terms)
        except TypeError:
            return f"terms is not iterable ({type(req.terms).__name__})"
        if not pairs:
            return "empty document (no terms)"
        for entry in pairs:
            try:
                term, weight = entry
                term, weight = int(term), float(weight)
            except (TypeError, ValueError):
                return f"term entry {entry!r} is not a (term_id, weight) pair"
            if not math.isfinite(weight):
                return f"term {term} has non-finite weight {weight!r}"
        if not any(0 <= int(t) < self.n_terms for t, _ in pairs):
            return (f"no term id falls inside the model vocabulary "
                    f"[0, {self.n_terms})")
        return None

    def _pack_terms(self, term_lists: Sequence[Sequence[Tuple[int, float]]]):
        """Term lists -> one (n_terms, n_docs) padded-CSR matrix on the host
        (out-of-vocabulary term ids dropped), for a tick or a refresh."""
        rows, cols, vals = [], [], []
        for doc, terms in enumerate(term_lists):
            for term, weight in terms:
                if 0 <= term < self.n_terms:
                    rows.append(term)
                    cols.append(doc)
                    vals.append(float(weight))
        return from_coo(
            np.asarray(rows, np.int64), np.asarray(cols, np.int64),
            np.asarray(vals, np.float32), (self.n_terms, len(term_lists)))

    def refresh(self, iters: Optional[int] = None,
                forget: float = 1.0) -> int:
        """Fold the documents served since the last refresh into the
        estimator with one ``partial_fit``; returns how many (0 when the
        buffer is empty).  ``iters`` / ``forget`` pass through.

        A transaction: the factors and streaming statistics are kept first.
        An update that leaves the model unhealthy (``health_ >= 0``, one
        read from the device) is rolled back, the documents go back into
        the buffer, and the server keeps serving the last good topic space
        (``refresh_failures`` counts these).  An update that raises is
        rolled back and re-buffered the same way, and the exception
        propagates: a failing kernel or card is never served around."""
        if not self._refresh_buf:
            return 0
        docs = list(self._refresh_buf)
        self._refresh_buf.clear()
        est = self.estimator
        snap = {name: getattr(est, name, None)
                for name in ("u_", "v_", "_av_acc", "_gv_acc",
                             "n_docs_seen_", "health_")}

        def roll_back():
            for name, val in snap.items():
                setattr(est, name, val)
            self._refresh_buf.extend(docs)  # retried at the next refresh
            self.refresh_failures += 1

        try:
            est.partial_fit(self._pack_terms(docs), iters=iters,
                            forget=forget)
            health = est.health_
            healthy = health is None or int(health) < 0
        except BaseException:
            roll_back()
            raise
        if not healthy:
            roll_back()
            warnings.warn(
                f"topic refresh over {len(docs)} document(s) produced "
                f"non-finite factors (health_={int(health)}) and was rolled "
                f"back; serving continues on the previous topic space",
                RuntimeWarning)
            return 0
        self.refreshed += len(docs)
        return len(docs)

    def step(self) -> Dict[int, List[Tuple[int, float]]]:
        """Serve one micro-batch; returns ``{rid: [(topic, loading), ...]}``."""
        if not self.queue:
            return {}
        batch, self.queue = (self.queue[: self.max_batch],
                             self.queue[self.max_batch:])
        out = {}
        good = []
        for req in batch:
            reason = self._validate(req)
            if reason is None:
                good.append(req)
            else:
                req.error = reason
                req.topics = []
                out[req.rid] = []
                self.rejected += 1
        if not good:
            self.served += len(batch)
            return out
        est = self.estimator
        t0 = time.perf_counter()
        packed = self._pack_terms([req.terms for req in good])
        t1 = time.perf_counter()
        a_new = est._coerce(packed)
        t2 = time.perf_counter()
        v = est.transform(a_new)                     # (batch, k)
        order = torch.argsort(-v, dim=1, stable=True)
        if v.device.type == "cuda":
            v_h = v.to("cpu", non_blocking=True)
            order_h = order.to("cpu", non_blocking=True)
            torch.cuda.current_stream(v.device).synchronize()
        else:
            v_h, order_h = v, order
        v_np, order_np = v_h.numpy(), order_h.numpy()
        t3 = time.perf_counter()
        self.stats["ticks"] += 1
        self.stats["pack_s"] += t1 - t0
        self.stats["ingest_s"] += t2 - t1
        self.stats["device_s"] += t3 - t2
        for doc, req in enumerate(good):
            picks = [
                (int(t), float(v_np[doc, t]))
                for t in order_np[doc, : req.top]
                if v_np[doc, t] > 0
            ]
            req.topics = picks
            out[req.rid] = picks
        self.served += len(batch)
        self._refresh_buf.extend(req.terms for req in good)
        if (self.refresh_every is not None
                and len(self._refresh_buf) >= self.refresh_every):
            self.refresh()
        return out

    def run_until_drained(self, max_ticks: int = 1000) -> List[TopicRequest]:
        done: List[TopicRequest] = []
        for _ in range(max_ticks):
            if not self.queue:
                break
            n_before = len(self.queue)
            batch = self.queue[: self.max_batch]
            self.step()
            done.extend(batch)
            assert len(self.queue) < n_before  # step always drains
        return done
