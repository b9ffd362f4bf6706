"""Index construction from embedding sources (counterpart of
``deeplearning4j_tpu/retrieval/build.py``).

- ``(n, d)`` arrays, indexed as they are;
- a network's penultimate layer (``feed_forward`` activations over a
  corpus of inputs, chunked);
- Word2Vec-family and DeepWalk/Node2Vec models, duck-typed
  (``get_word_vector_matrix`` / ``get_vertex_vector``): they serve once
  the port's ``nlp/`` and ``graphs/`` exist.

``build_index_streaming`` is the two-pass build for corpora beyond host
RAM: a seeded reservoir subsample trains the PQ codebooks (and IVF cells)
on pass one, pass two encodes codes chunk by chunk. Sources: a callable
returning a fresh iterator, an ``(n, d)`` array, a re-iterable of arrays, or
an iterator with ``reset()``. Sharded data-tier readers (``bind_epoch``)
wait for the port's data tier.

``synthetic_corpus`` is the JAX package's seeded clustered corpus, bitwise.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.retrieval.index import (BruteForceIndex, IVFIndex,
                                                      _assign_all, _train_cells)
from deeplearning4j_tpu_torch.retrieval.pq import (IVFPQIndex, PQCodec, PQIndex,
                                                   assemble_ivf_pq_index,
                                                   assemble_pq_index)

__all__ = ["vectors_from_word2vec", "vectors_from_graph",
           "vectors_from_model", "build_index", "build_index_streaming",
           "synthetic_corpus"]


def synthetic_corpus(n: int, d: int, *, n_clusters: Optional[int] = None,
                     spread: float = 0.5, seed: int = 0,
                     queries: int = 0):
    """Seeded clustered corpus for smoke tests, benches and demos. Returns
    a float32 ``(n, d)`` matrix, or ``(V, Q)`` when ``queries`` > 0
    (queries drawn from the same mixture)."""
    rng = np.random.default_rng(seed)
    nc = max(16, n // 100) if n_clusters is None else int(n_clusters)
    means = rng.standard_normal((nc, d)).astype(np.float32) * 2.0
    V = (means[rng.integers(0, nc, n)]
         + rng.standard_normal((n, d)).astype(np.float32) * spread)
    if not queries:
        return V
    Q = (means[rng.integers(0, nc, queries)]
         + rng.standard_normal((queries, d)).astype(np.float32) * spread)
    return V, Q


def vectors_from_word2vec(vectors) -> Tuple[list, np.ndarray]:
    """(words, matrix) from a trained ``SequenceVectors`` family model —
    row i is the vector of vocab word i."""
    if getattr(vectors, "vocab", None) is None \
            or getattr(vectors, "syn0", None) is None:
        raise ValueError("embedding model is not fitted (no vocab/table)")
    words = vectors.vocab.words()
    mat = np.asarray(vectors.get_word_vector_matrix(), np.float32)
    # subclasses may append non-word rows (doc vectors); index only the
    # rows that answer as words
    return list(words), mat[:len(words)]


def vectors_from_graph(graph_vectors) -> Tuple[list, np.ndarray]:
    """(vertex-id labels, matrix) from a fitted DeepWalk/Node2Vec — rows
    ordered by vertex id."""
    n = getattr(graph_vectors, "num_vertices", 0)
    if not n:
        raise ValueError("graph embedding model is not fitted")
    rows = [np.asarray(graph_vectors.get_vertex_vector(v), np.float32)
            for v in range(n)]
    return [str(v) for v in range(n)], np.stack(rows)


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):  # a tensor, possibly on the card
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def vectors_from_model(net, inputs, layer: int = -2,
                       chunk: int = 1024) -> np.ndarray:
    """Penultimate-layer (default) activation matrix over ``inputs``.
    ``layer`` indexes ``feed_forward``'s activation list (-1 is the output
    head); activations flatten to (n, features)."""
    x = np.asarray(inputs, np.float32)
    out = []
    for lo in range(0, len(x), int(chunk)):
        acts = net.feed_forward(x[lo:lo + int(chunk)])
        a = _host(acts[layer])
        out.append(a.reshape(a.shape[0], -1))
    return np.concatenate(out, axis=0)


def build_index(source, kind: str = "brute", *,
                inputs=None, layer: int = -2,
                labels: Optional[Sequence[str]] = None, **index_kwargs):
    """One constructor for every source: an ``(n, d)`` array, a
    Word2Vec-family model, a DeepWalk/Node2Vec model, or a network +
    ``inputs=`` corpus (penultimate activations). ``kind`` is ``"brute"``,
    ``"ivf"``, ``"pq"`` or ``"ivf_pq"``; everything else (``int8=``, ``int4=``,
    ``nprobe=``, ``M=``, ``rerank=``, ``metric=``, ``device=`` …) forwards
    to the index."""
    cls = _INDEX_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown index kind {kind!r} "
                         f"(known: {sorted(_INDEX_KINDS)})")
    if hasattr(source, "get_word_vector_matrix"):
        labels, mat = vectors_from_word2vec(source)
    elif hasattr(source, "get_vertex_vector"):
        labels, mat = vectors_from_graph(source)
    elif hasattr(source, "feed_forward"):
        if inputs is None:
            raise ValueError("indexing a network's activations needs "
                             "inputs= (the corpus to embed)")
        mat = vectors_from_model(source, inputs, layer=layer)
    else:
        mat = _host(source)
    return cls(mat, labels=labels, **index_kwargs)


_INDEX_KINDS = {"brute": BruteForceIndex, "ivf": IVFIndex, "pq": PQIndex,
                "ivf_pq": IVFPQIndex}


# ======================================================== streaming build
def _chunk_pass(source):
    """One pass over a re-startable batch source, yielding float32 (b, d)
    arrays: a CALLABLE returning a fresh iterator, an iterator with
    ``reset()`` (each batch's flattened ``features``), an ``(n, d)`` array
    (sliced), or a re-iterable of arrays (list/tuple)."""
    if callable(source):
        it = source()
    elif hasattr(source, "reset") and hasattr(source, "__iter__"):
        source.reset()
        it = source
    elif isinstance(source, np.ndarray):
        def _slices(a):
            for lo in range(0, len(a), 16384):
                yield a[lo:lo + 16384]
        it = _slices(source)
    else:
        it = iter(source)
    for item in it:
        a = _host(getattr(item, "features", item))  # DataSet batches
        if a.ndim != 2:
            a = a.reshape(a.shape[0], -1)
        if len(a):
            yield a


def _rebuffer(chunks, rows: int):
    """Re-chunk a ragged batch stream into ~``rows``-row chunks."""
    buf: list = []
    held = 0
    for c in chunks:
        buf.append(c)
        held += len(c)
        if held >= rows:
            whole = np.concatenate(buf, axis=0)
            buf, held = [], 0
            for lo in range(0, len(whole), rows):
                part = whole[lo:lo + rows]
                if len(part) == rows:
                    yield part
                else:
                    buf, held = [part], len(part)
    if buf:
        yield np.concatenate(buf, axis=0)


def _reservoir_pass(source, capacity: int, seed: int):
    """Seeded uniform reservoir over the stream (bottom-``capacity`` of
    iid random keys — kept rows returned in STREAM order, so a corpus
    that fits the reservoir reproduces the materialized build's training
    sample exactly). Returns ``(sample, n_total, d)``."""
    rng = np.random.default_rng(seed)
    best_keys = best_rows = best_gidx = None
    n = 0
    d = None
    for c in _chunk_pass(source):
        d = c.shape[1] if d is None else d
        if c.shape[1] != d:
            raise ValueError(f"batch width changed mid-stream: {d} -> "
                             f"{c.shape[1]}")
        keys = rng.random(len(c))
        gidx = np.arange(n, n + len(c))
        n += len(c)
        if best_keys is None:
            best_keys, best_rows, best_gidx = keys, c.copy(), gidx
        else:
            best_keys = np.concatenate([best_keys, keys])
            best_rows = np.concatenate([best_rows, c], axis=0)
            best_gidx = np.concatenate([best_gidx, gidx])
        if len(best_keys) > capacity:
            keep = np.argpartition(best_keys, capacity)[:capacity]
            best_keys = best_keys[keep]
            best_rows = best_rows[keep]
            best_gidx = best_gidx[keep]
    if not n:
        raise ValueError("streaming source yielded no rows")
    order = np.argsort(best_gidx, kind="stable")
    return best_rows[order], n, d


def _probe_distortion(codec: PQCodec, rows: np.ndarray, seed: int) -> float:
    """Distortion on a seeded ≤4096-row subsample."""
    rng = np.random.default_rng(seed)
    probe = (rows if len(rows) <= 4096
             else rows[rng.choice(len(rows), 4096, replace=False)])
    return codec.distortion(probe, codec.encode(probe))


def _check_second_pass(got: int, n: int):
    """Pass 2 must replay exactly the rows pass 1 counted."""
    if got != n:
        raise ValueError(
            f"streaming source yielded {got} rows on the encode pass but "
            f"{n} on the reservoir pass — the source must be "
            "RE-STARTABLE (pass a generator FACTORY, an iterator with "
            "reset(), an array, or a re-iterable — not a one-shot "
            "generator) and stable between passes")


def build_index_streaming(source, kind: str = "pq", *,
                          train_size: int = 65_536,
                          chunk_rows: int = 16_384,
                          n_cells: Optional[int] = None, nprobe: int = 8,
                          M: int = 8, ksub: int = 256,
                          max_iterations: int = 25, seed: int = 0,
                          labels: Optional[Sequence[str]] = None,
                          device=None):
    """Chunked two-pass index build for corpora that exceed host RAM.

    Pass 1 draws a seeded ``train_size`` reservoir subsample (and counts
    the corpus); PQ codebooks — and, for ``ivf_pq``, the KMeans cells —
    train on the sample. Pass 2 re-reads the stream and encodes codes
    chunk by chunk. A corpus that fits the reservoir builds the same index
    as the materialized constructor with the same seed. ``rerank`` is not
    offered: it needs the fp32 table this path exists to avoid."""
    if kind not in ("pq", "ivf_pq"):
        raise ValueError(
            f"streaming build supports the PQ kinds ('pq', 'ivf_pq'); "
            f"got {kind!r} — materialize the corpus and use build_index "
            "for fp32/int8/int4 tables (their device table IS the "
            "matrix)")
    if hasattr(source, "bind_epoch") or hasattr(source, "epoch_order"):
        raise NotImplementedError(
            "sharded data-tier sources (ShardedReader, ShardedDataset) come "
            "with the port's data tier; pass a generator factory, an array "
            "or a re-iterable of arrays")
    sample, n, d = _reservoir_pass(source, int(train_size), int(seed))
    if labels is not None and len(labels) != n:
        raise ValueError(f"labels length {len(labels)} != corpus rows {n}")
    codec = PQCodec(M, ksub, seed=seed, max_iterations=max_iterations,
                    device=device)
    if kind == "pq":
        codec.train(sample)
        parts = [codec.encode(c) for c in
                 _rebuffer(_chunk_pass(source), int(chunk_rows))]
        codes = (np.concatenate(parts, axis=0) if parts
                 else np.empty((0, codec.M), np.uint8))
        _check_second_pass(len(codes), n)
        distortion = _probe_distortion(codec, sample, seed)
        return assemble_pq_index(
            codec, codes, size=n, dim=d, labels=labels,
            distortion=distortion, seed=seed, train_size=train_size,
            max_iterations=max_iterations, device=device)
    cells = (max(1, int(round(n ** 0.5))) if n_cells is None
             else int(n_cells))
    centroids, sample_assign = _train_cells(
        sample, min(cells, len(sample)), train_size, max_iterations, seed,
        device)
    res_sample = sample - centroids[sample_assign]
    codec.train(res_sample)
    code_parts, assign_parts = [], []
    for c in _rebuffer(_chunk_pass(source), int(chunk_rows)):
        a = _assign_all(c, centroids, device)
        code_parts.append(codec.encode(c - centroids[a]))
        assign_parts.append(a)
    codes = (np.concatenate(code_parts, axis=0) if code_parts
             else np.empty((0, codec.M), np.uint8))
    assign = (np.concatenate(assign_parts) if assign_parts
              else np.empty(0, np.int64))
    _check_second_pass(len(codes), n)
    distortion = _probe_distortion(codec, res_sample, seed)
    return assemble_ivf_pq_index(
        codec, codes, assign, centroids, nprobe=nprobe, size=n, dim=d,
        labels=labels, distortion=distortion, seed=seed,
        train_size=train_size, max_iterations=max_iterations, device=device)
