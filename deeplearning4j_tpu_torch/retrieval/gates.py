"""Recall gates: does the approximate/compressed index still answer like
exact brute force? (counterpart of ``deeplearning4j_tpu/retrieval/gates.py``;
the ``retrieval_recall_*`` gauge waits for the port's obs registry)

- ``recall_at_k(index, queries, k)`` — fraction of the exact top-k (a
  float32 :class:`~deeplearning4j_tpu_torch.retrieval.index.BruteForceIndex`
  over the same corpus) that the index returns, averaged over queries.
- ``recall_delta(a, b, queries, k)`` — paired report of two indexes
  against the same exact reference.
- ``assert_recall_within(...)`` — the gate: minimum absolute recall
  and/or maximum delta vs a baseline index; raises
  :class:`RecallGateError` with the measured numbers when violated.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["recall_at_k", "recall_delta", "assert_recall_within",
           "RecallGateError"]


class RecallGateError(AssertionError):
    """An index fell outside its stated recall budget."""


def _exact_for(index, queries, k: int) -> np.ndarray:
    from deeplearning4j_tpu_torch.retrieval.index import BruteForceIndex

    # compressed tables (int8/int4/PQ codes) hold rounded rows: the caller
    # passes the float exact reference
    if getattr(index, "codec", "fp32") != "fp32" \
            or not isinstance(index, BruteForceIndex):
        raise ValueError(
            f"recall of a {index.codec} {index.kind} index needs an explicit "
            "float32 exact reference — pass exact=BruteForceIndex("
            "original_vectors)")
    return index.search(queries, k)[0]


def recall_at_k(index, queries, k: int = 10, *, exact=None) -> float:
    """Mean fraction of the exact top-k recovered per query. ``exact`` is
    a BruteForceIndex over the same (float32) corpus, a precomputed
    (b, k) exact-indices array, or None for a float32 brute-force index
    (its own answers)."""
    q = np.atleast_2d(np.asarray(queries, np.float32))
    got, _ = index.search(q, k)
    if exact is None:
        want = _exact_for(index, q, k)
    elif isinstance(exact, np.ndarray):
        want = exact[:, :k]
    else:
        want = exact.search(q, k)[0]
    hits = sum(len(np.intersect1d(g, w)) for g, w in zip(got, want))
    return hits / float(want.shape[0] * k)


def recall_delta(a, b, queries, k: int = 10, *, exact=None) -> dict:
    """Paired recall report: ``a`` (e.g. an int8 index) vs ``b`` (its
    float source), both against the same exact reference."""
    ra = recall_at_k(a, queries, k, exact=exact)
    rb = recall_at_k(b, queries, k, exact=exact)
    return {"recall_a": ra, "recall_b": rb, "delta": rb - ra, "k": k}


def assert_recall_within(index, queries, k: int = 10, *,
                         min_recall: Optional[float] = None,
                         baseline=None, max_delta: Optional[float] = None,
                         exact=None) -> dict:
    """The gate. ``min_recall`` bounds absolute recall@k; ``baseline`` +
    ``max_delta`` bound the recall lost vs another index over the same
    corpus. Returns the measured report; raises :class:`RecallGateError`
    outside budget."""
    if min_recall is None and (baseline is None or max_delta is None):
        raise ValueError("state a budget: min_recall=, or baseline= with "
                         "max_delta=")
    report = {"k": k}
    r = recall_at_k(index, queries, k, exact=exact)
    report["recall"] = r
    if min_recall is not None and r < min_recall:
        codec = getattr(index, "codec", "fp32")
        tag = index.kind + (f"+{codec}" if codec != "fp32"
                            and codec not in index.kind else "")
        remedy = {
            "pq": "raise M/ksub, turn on rerank=, or probe more cells "
                  "(IVF-PQ)",
            "int8": "use a finer observer",
            "int4": "turn on rerank= (the int4 grid is coarse by "
                    "design) or step back up to int8",
        }.get(codec, "rebuild the index")
        raise RecallGateError(
            f"recall@{k} = {r:.4f} below the stated floor {min_recall} "
            f"for {tag} — {remedy}, or relax the budget deliberately")
    if baseline is not None and max_delta is not None:
        rb = recall_at_k(baseline, queries, k, exact=exact)
        report["baseline_recall"] = rb
        report["delta"] = rb - r
        if rb - r > max_delta:
            raise RecallGateError(
                f"recall@{k} dropped {rb - r:.4f} vs baseline "
                f"({rb:.4f} -> {r:.4f}), over the {max_delta} budget")
    return report
