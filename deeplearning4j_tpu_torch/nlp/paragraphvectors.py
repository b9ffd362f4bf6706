"""ParagraphVectors (doc2vec), the JAX package's
``nlp/paragraphvectors.py`` on PyTorch.

Parity surface: reference ``models/paragraphvectors/ParagraphVectors.java:60``
with ``DBOW.java`` (the doc vector predicts each word) and ``DM.java`` (the
doc vector joins every context bag). Document vectors are extra rows after
the V word rows of ``syn0``, so the same steps train words and documents:
DBOW is ``sgns_step`` with the document row as the input-side index, DM is
``cbow_step`` with the document row appended to each bag. ``infer_vector``
runs the frozen-table steps (``sgns_infer_step`` / ``cbow_infer_step``)
and never changes the model."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp import kernels
from deeplearning4j_tpu_torch.nlp.sentenceiterator import (
    LabelAwareIterator, LabelAwareListSentenceIterator, LabelledDocument,
    SimpleLabelAwareIterator,
)
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec

Docs = Union[LabelAwareIterator, Sequence[LabelledDocument], Sequence[str]]


class ParagraphVectors(Word2Vec):
    """PV-DM (``dm=True``) / PV-DBOW (``dm=False``) document embeddings;
    ``train_words`` also runs skip-gram over the words."""

    def __init__(self, dm: bool = True, train_words: bool = False, **kwargs):
        super().__init__(**kwargs)
        self.dm = dm
        self.train_words = train_words
        self.label_index: Dict[str, int] = {}

    # ------------------------------------------------------------ documents
    def _as_docs(self, documents: Docs) -> LabelAwareIterator:
        if isinstance(documents, LabelAwareIterator):
            return documents
        documents = list(documents)
        if documents and isinstance(documents[0], LabelledDocument):
            return SimpleLabelAwareIterator(documents)
        return LabelAwareListSentenceIterator(list(documents))

    def _doc_tokens(self, doc: LabelledDocument) -> List[str]:
        return self.tokenizer_factory.create(doc.content).get_tokens()

    # -------------------------------------------------------------- training
    def fit(self, documents: Docs, chunk_docs: int = 256):
        it = self._as_docs(documents)
        if self.vocab is None:
            it.reset()
            self.build_vocab(self._doc_tokens(d) for d in it)
        it.reset()
        for d in it:
            for lbl in d.labels:
                self.label_index.setdefault(lbl, len(self.label_index))
        if self.syn0 is None:
            self._init_tables()
        # one doc row per label after the V word rows; a refit with new
        # labels grows the table
        want = self.vocab.num_words() + len(self.label_index)
        have = self.syn0.shape[0]
        if have < want:
            D = self.syn0.shape[1]
            doc_rows = (self._rng.random((want - have, D), np.float32) - 0.5) / D
            self.syn0 = torch.cat([self.syn0, self._tensor(doc_rows)])
        widx = {vw.word: vw.index for vw in self.vocab.vocab_words()}
        V = self.vocab.num_words()
        total = self.vocab.total_word_occurrences * self.epochs * self.iterations
        for _ in range(self.epochs):
            chunk: List[Tuple[np.ndarray, int]] = []
            it.reset()
            for d in it:
                idx = [widx[t] for t in self._doc_tokens(d) if t in widx]
                if not idx or not d.labels:
                    continue
                for lbl in d.labels:
                    chunk.append((np.asarray(idx, np.int64), V + self.label_index[lbl]))
                if len(chunk) >= chunk_docs:
                    self._fit_doc_chunk(chunk, total)
                    chunk = []
            if chunk:
                self._fit_doc_chunk(chunk, total)
        return self

    def _fit_doc_chunk(self, chunk, total_expected):
        seqs = [c[0] for c in chunk]
        doc_rows = np.asarray([c[1] for c in chunk], np.int64)
        for _ in range(self.iterations):
            lr = self._lr(total_expected)
            if self.dm:
                centers, bags, bmask, rows = self._bags_with_docs(seqs, doc_rows)
                if len(centers):
                    bags = np.concatenate([bags, rows[:, None]], axis=1)
                    bmask = np.concatenate(
                        [bmask, np.ones((len(bmask), 1), np.float32)], axis=1)
                    self._train_bags(centers, bags, bmask, lr)
            else:
                flat = np.concatenate(seqs)
                rows = np.repeat(doc_rows, [len(s) for s in seqs])
                self._train_pairs(flat, rows, lr)
            if self.train_words:
                centers, contexts = self._pairs_for_chunk(seqs)
                if len(centers):
                    self._train_pairs(centers, contexts, lr)
            self.words_processed += sum(len(s) for s in seqs)

    def _bags_with_docs(self, seqs, doc_rows, rng=None):
        """_bags_for_chunk plus each surviving center's doc row. ``rng``
        defaults to the model's; inference passes a seed-local one."""
        rng = rng if rng is not None else self._rng
        flat = np.concatenate(seqs)
        sid = np.repeat(np.arange(len(seqs)), [len(s) for s in seqs])
        flat, sid = self._subsample(flat, sid)
        n = len(flat)
        w = self.window_size
        if n < 1:
            return (np.zeros(0, np.int64), np.zeros((0, 2 * w), np.int64),
                    np.zeros((0, 2 * w), np.float32), np.zeros(0, np.int64))
        bags, mask = self._bags(flat, sid, rng.integers(1, w + 1, n))
        # unlike plain CBOW, a bag may be empty: the doc row still predicts
        return flat, bags, mask, doc_rows[sid]

    # ------------------------------------------------------------- inference
    def infer_vector(self, text: str, learning_rate: Optional[float] = None,
                     iterations: int = 30, seed: int = 0) -> np.ndarray:
        """A fresh doc vector trained against the frozen model (reference
        inferVector). Negative-sampling models only."""
        if self.syn0 is None:
            raise ValueError("model is not trained")
        if self.negative <= 0:
            raise NotImplementedError(
                "infer_vector requires negative sampling (negative > 0)")
        widx = {vw.word: vw.index for vw in self.vocab.vocab_words()}
        tokens = self.tokenizer_factory.create(text).get_tokens()
        idx = np.asarray([widx[t] for t in tokens if t in widx], np.int64)
        D = self.syn0.shape[1]
        rng = np.random.default_rng(seed)
        docvec = (rng.random(D, np.float32) - 0.5) / D
        if len(idx) == 0:
            return docvec
        lr = learning_rate if learning_rate is not None else self.learning_rate
        b = self.batch_size
        if self.dm:
            # no subsampling at inference
            sampling, self.sampling = self.sampling, 0.0
            try:
                centers, bags, bmask, _ = self._bags_with_docs(
                    [idx], np.zeros(1, np.int64), rng=rng)
            finally:
                self.sampling = sampling
        else:
            centers = idx
        dv = self._tensor(docvec)
        for _ in range(iterations):
            for s in range(0, len(centers), b):
                ce, wmask = self._pad(centers[s:s + b], b)
                if wmask is None:
                    wmask = np.ones(b, np.float32)
                negs = self._neg_table[rng.integers(
                    0, len(self._neg_table), (b, self.negative))].astype(np.int32)
                ce_t, negs_t, wm_t = self._batch_tensors(ce.astype(np.int32), negs, wmask)
                if self.dm:
                    bg, _ = self._pad(bags[s:s + b], b)
                    bm, _ = self._pad(bmask[s:s + b], b)
                    dv, _ = kernels.cbow_infer_step(
                        dv, self.syn0, self.syn1, ce_t,
                        *self._batch_tensors(bg.astype(np.int32), bm.astype(np.float32)),
                        negs_t, wm_t, lr)
                else:
                    dv, _ = kernels.sgns_infer_step(dv, self.syn1, ce_t, negs_t, wm_t, lr)
        return dv.cpu().numpy()

    # ------------------------------------------------------------- accessors
    def doc_vector(self, label: str) -> Optional[np.ndarray]:
        i = self.label_index.get(label)
        if i is None or self.syn0 is None:
            return None
        return self.syn0[self.vocab.num_words() + i].cpu().numpy()

    def labels(self) -> List[str]:
        return sorted(self.label_index, key=self.label_index.get)

    def get_word_vector_matrix(self) -> np.ndarray:
        return self.syn0[: self.vocab.num_words()].cpu().numpy()

    def similarity_to_label(self, text: str, label: str) -> float:
        """Cosine between an inferred vector for ``text`` and a trained doc
        vector (reference similarityToLabel)."""
        v = self.infer_vector(text)
        d = self.doc_vector(label)
        if d is None:
            return float("nan")
        denom = (np.linalg.norm(v) * np.linalg.norm(d)) or 1e-12
        return float(v @ d / denom)

    def predict(self, text: str) -> Optional[str]:
        """Most similar label for a text (reference predict)."""
        if not self.label_index:
            return None
        v = self.infer_vector(text)
        docs = self.syn0[self.vocab.num_words():].cpu().numpy()
        norms = np.linalg.norm(docs, axis=1) * (np.linalg.norm(v) or 1e-12)
        sims = (docs @ v) / np.maximum(norms, 1e-12)
        return self.labels()[int(np.argmax(sims))]
