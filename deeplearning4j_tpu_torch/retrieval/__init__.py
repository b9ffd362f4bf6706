"""retrieval/ — vector retrieval on the card (counterpart of
``deeplearning4j_tpu/retrieval/``): brute-force top-k over a resident
corpus (fp32, int8, packed int4 through ``int4_dot``), the inverted-file
``IVFIndex`` (dense or CSR cells, fp32 / int8 / int4 residual codes), PQ
codebooks scored
by ADC (flat ``PQIndex`` through ``adc_pq``, ``IVFPQIndex`` over residuals
through ``adc_ivf_pq``, opt-in exact re-rank), recall gates, builders
(arrays, networks, a streaming two-pass build) and a batched serving
endpoint.

    from deeplearning4j_tpu_torch import retrieval
    ix = retrieval.PQIndex(vectors, M=8, rerank=16)          # on cuda
    retrieval.assert_recall_within(ix, queries, k=10, min_recall=0.95,
                                   exact=retrieval.BruteForceIndex(vectors))
    ep = retrieval.IndexEndpoint("words", ix).warmup()
    ids, dists = ep.query(queries[:4], k=10)

``device="cpu"`` on any constructor or ``load_index`` runs the plain
versions of the kernels.
"""

from deeplearning4j_tpu_torch.retrieval.index import (  # noqa: F401
    BruteForceIndex, IVFIndex, load_index)
from deeplearning4j_tpu_torch.retrieval.pq import (  # noqa: F401
    IVFPQIndex, PQCodec, PQIndex)
from deeplearning4j_tpu_torch.retrieval.gates import (  # noqa: F401
    RecallGateError, assert_recall_within, recall_at_k, recall_delta)
from deeplearning4j_tpu_torch.retrieval.build import (  # noqa: F401
    build_index, build_index_streaming, synthetic_corpus,
    vectors_from_graph, vectors_from_model, vectors_from_word2vec)
from deeplearning4j_tpu_torch.retrieval.service import (  # noqa: F401
    IndexDispatchError, IndexEndpoint)

__all__ = [
    "BruteForceIndex", "IVFIndex", "PQIndex", "IVFPQIndex", "PQCodec",
    "load_index",
    "RecallGateError", "assert_recall_within", "recall_at_k",
    "recall_delta",
    "build_index", "build_index_streaming", "synthetic_corpus",
    "vectors_from_word2vec", "vectors_from_graph", "vectors_from_model",
    "IndexEndpoint", "IndexDispatchError",
]
