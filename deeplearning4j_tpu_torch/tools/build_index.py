"""Offline vector-index build CLI (retrieval/ subsystem; counterpart of
the JAX package's ``tools/build_index.py``, whose ``.npz`` it reads and
writes). It runs on ``cuda`` unless given ``--device cpu``.

Build a device-servable index from a vector source, gate its recall, and
save the ``.npz`` that ``retrieval.load_index`` (and a serving replica's
hot-swap rebuild) loads in milliseconds::

    python -m deeplearning4j_tpu_torch.tools.build_index --vectors corpus.npy --kind ivf \
        --int8 --nprobe 8 --out words.idx.npz --gate-min-recall 0.95

    # compression rungs: --int4 (packed nibbles, half the int8 code
    # bytes), --pq M [--ksub K --rerank R] (PQ codebooks + ADC; with
    # --kind ivf -> IVF-PQ over residuals), --csr (IVF flat cell layout,
    # no dense padding waste); the summary prints bytes_per_vector
    python -m deeplearning4j_tpu_torch.tools.build_index --vectors corpus.npy --kind ivf --pq 8 \
        --rerank 16 --out words.pq.npz --gate-min-recall 0.95

    # smoke-query the saved index
    python -m deeplearning4j_tpu_torch.tools.build_index --load words.idx.npz --query-random 4

Vector sources (``--vectors``):

- ``path.npy`` — a raw (n, d) float matrix
- ``path.npz[:key]`` — an array from an .npz archive (default key ``x``)
- ``random:<n>x<d>[@seed]`` — a synthetic clustered corpus (smoke tests)

``--gate-min-recall`` runs ``retrieval.assert_recall_within`` on a held-
out sample of the corpus itself before saving — a failed gate exits
nonzero and writes nothing, the quant-CLI precedent: an index that lost
too much recall never reaches serving.

Serve the result through ``serving.ModelServer.add_index`` (see README
"Vector retrieval" for the endpoint recipe and the hot-swap rebuild).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _load_vectors(spec: str) -> np.ndarray:
    if spec.startswith("random:"):
        from deeplearning4j_tpu_torch.retrieval import synthetic_corpus
        body = spec[len("random:"):]
        seed = 0
        if "@" in body:
            body, s = body.rsplit("@", 1)
            seed = int(s)
        n, d = (int(x) for x in body.split("x"))
        return synthetic_corpus(n, d, seed=seed)
    path, _, key = spec.partition(":")
    if path.endswith(".npz"):
        with np.load(path) as z:
            return np.asarray(z[key or "x"], np.float32)
    return np.asarray(np.load(path), np.float32)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--vectors", help="vector source (npy/npz/random: spec)")
    p.add_argument("--kind", choices=("brute", "ivf"), default="ivf")
    p.add_argument("--metric", choices=("euclidean", "cosine"),
                   default="euclidean")
    p.add_argument("--int8", action="store_true",
                   help="int8-compress the table (quant/ symmetric grid)")
    p.add_argument("--int4", action="store_true",
                   help="int4-pack the table (two nibbles per byte, "
                        "half the int8 code bytes; quant/pack.py grid)")
    p.add_argument("--pq", type=int, default=None, metavar="M",
                   help="product-quantize into M subspaces (1 byte per "
                        "subspace per vector, ADC scoring); --kind brute "
                        "-> flat PQ, --kind ivf -> IVF-PQ over residuals")
    p.add_argument("--ksub", type=int, default=256,
                   help="PQ codewords per subspace (<= 256)")
    p.add_argument("--rerank", type=int, default=0, metavar="R",
                   help="compressed kinds: exact host-side re-rank of "
                        "the top R*k approximate candidates against the "
                        "fp32 table (kept host-side; recovers recall at "
                        "high compression)")
    p.add_argument("--csr", action="store_true",
                   help="IVF only: CSR cell layout (flat cell-major "
                        "rows + offsets — no dense cap-count padding "
                        "waste on skewed cells; IVF-PQ is CSR already)")
    p.add_argument("--observer", default=None,
                   choices=("minmax", "percentile"),
                   help="table-clip observer for --int8/--int4 "
                        "(default minmax; not a PQ knob)")
    p.add_argument("--n-cells", type=int, default=None,
                   help="IVF cells (default sqrt(n))")
    p.add_argument("--nprobe", type=int, default=8)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--out", help="output .npz path")
    p.add_argument("--gate-min-recall", type=float, default=None,
                   help="recall@--gate-k floor asserted on a held-out "
                        "corpus sample before saving")
    p.add_argument("--gate-k", type=int, default=10)
    p.add_argument("--gate-queries", type=int, default=128)
    p.add_argument("--load", help="load an existing index instead of "
                                  "building")
    p.add_argument("--query-random", type=int, default=0, metavar="B",
                   help="smoke-query B random vectors and print results")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from deeplearning4j_tpu_torch import retrieval
    from deeplearning4j_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    if args.load:
        ix = retrieval.load_index(args.load, device=device)
        print(json.dumps({"loaded": args.load, **{
            k: v for k, v in ix.stats().items() if k != "compile_watch"}}))
    else:
        if not args.vectors:
            print("need --vectors (or --load)", file=sys.stderr)
            return 2
        if args.int8 and args.int4 or (args.pq and (args.int8 or args.int4)):
            print("--int8/--int4/--pq are one codec knob — pick one",
                  file=sys.stderr)
            return 2
        v = _load_vectors(args.vectors)
        kind = args.kind
        if args.csr and args.kind != "ivf":
            print("--csr is an IVF cell-layout knob (--kind ivf)",
                  file=sys.stderr)
            return 2
        if args.pq:
            if args.metric != "euclidean":
                # forward nothing silently: PQ codebooks are euclidean
                # centroids, and a mismatched gate oracle would judge
                # the wrong geometry
                print("--pq indexes are euclidean-only (codebooks are "
                      "euclidean centroids); drop --metric",
                      file=sys.stderr)
                return 2
            if args.observer:
                print("--observer is an int8/int4 clip knob; PQ "
                      "codebooks have no observer — drop it",
                      file=sys.stderr)
                return 2
            kind = "pq" if args.kind == "brute" else "ivf_pq"
            kwargs = dict(M=args.pq, ksub=args.ksub, rerank=args.rerank,
                          seed=args.seed)
            if kind == "ivf_pq":
                kwargs.update(n_cells=args.n_cells, nprobe=args.nprobe)
        else:
            kwargs = dict(metric=args.metric, int8=args.int8,
                          int4=args.int4, rerank=args.rerank,
                          observer=args.observer or "minmax")
            if args.kind == "ivf":
                kwargs.update(n_cells=args.n_cells, nprobe=args.nprobe,
                              seed=args.seed,
                              layout="csr" if args.csr else "dense")
        ix = retrieval.build_index(v, kind=kind, device=device, **kwargs)
        if args.gate_min_recall is not None:
            rng = np.random.default_rng(args.seed)
            q = v[rng.choice(len(v), min(args.gate_queries, len(v)),
                             replace=False)]
            exact = (retrieval.BruteForceIndex(v, metric=args.metric,
                                               device=device)
                     if (kind != "brute" or args.int8 or args.int4)
                     else None)
            try:
                report = retrieval.assert_recall_within(
                    ix, q, args.gate_k, min_recall=args.gate_min_recall,
                    exact=exact)
            except retrieval.RecallGateError as e:
                print(f"recall gate FAILED: {e}", file=sys.stderr)
                return 1
            print(json.dumps({"recall_gate": report}))
        st = {k: v2 for k, v2 in ix.stats().items()
              if k != "compile_watch"}
        print(json.dumps({"built": st}))
        if args.out:
            ix.save(args.out)
            print(json.dumps({"saved": args.out,
                              "bytes": os.path.getsize(args.out)}))
    if args.query_random:
        rng = np.random.default_rng(1)
        q = rng.standard_normal((args.query_random, ix.dim)).astype(
            np.float32)
        idx, dist = ix.search(q, min(5, ix.size))
        print(json.dumps({"query_smoke": {
            "indices": np.asarray(idx).tolist(),
            "distances": np.round(np.asarray(dist), 4).tolist()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
