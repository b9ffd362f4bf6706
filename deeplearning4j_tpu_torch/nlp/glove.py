"""GloVe embeddings, the JAX package's ``nlp/glove.py`` on PyTorch.

Parity surface: reference ``models/glove/Glove.java:43`` with the
co-occurrence counting of ``models/glove/count/``. The host builds the
sparse co-occurrence table in one vectorised pass (symmetric window,
1/distance weighting) with the JAX package's code; training is a shuffled
stream of (row, col, log x, f(x)) batches through ``kernels.glove_step``
(AdaGrad), whose eight scatters are ``scatter_add`` launches on the card."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nlp import kernels
from deeplearning4j_tpu_torch.nlp.word2vec import Corpus, Word2Vec


class Glove(Word2Vec):
    """GloVe trainer: ``x_max`` + ``alpha`` (weighting), ``learning_rate``
    (AdaGrad base), ``epochs``, ``layer_size``, ``window_size``,
    ``min_word_frequency``, ``symmetric``, ``shuffle``."""

    def __init__(self, x_max: float = 100.0, alpha: float = 0.75,
                 symmetric: bool = True, shuffle: bool = True, **kwargs):
        kwargs.setdefault("learning_rate", 0.05)
        super().__init__(**kwargs)
        self.x_max = x_max
        self.alpha = alpha
        self.symmetric = symmetric
        self.shuffle = shuffle
        self.syn0c = self.bias = self.bias_c = None
        self._gw = self._gwc = self._gb = self._gbc = None
        self.loss_history: List[float] = []

    # -------------------------------------------------------- co-occurrence
    def _cooccurrences(self, sequences) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Sparse symmetric co-occurrence counts with 1/distance weighting:
        per offset d, aligned slices of the flat corpus give every pair at
        distance d; pairs keyed i*V+j are summed with one bincount."""
        seqs = list(self._index_sequences(sequences))
        empty = (np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),)
        if not seqs:
            return empty
        flat = np.concatenate(seqs)
        sid = np.repeat(np.arange(len(seqs)), [len(s) for s in seqs])
        V = self.vocab.num_words()
        keys_all: List[np.ndarray] = []
        wts_all: List[np.ndarray] = []
        for d in range(1, self.window_size + 1):
            if len(flat) <= d:
                break
            same = sid[:-d] == sid[d:]
            i, j = flat[:-d][same], flat[d:][same]
            wt = np.full(len(i), 1.0 / d, np.float64)
            keys_all.append(i * V + j)
            wts_all.append(wt)
            if self.symmetric:
                keys_all.append(j * V + i)
                wts_all.append(wt)
        if not keys_all:
            return empty
        keys = np.concatenate(keys_all)
        wts = np.concatenate(wts_all)
        uniq, inv = np.unique(keys, return_inverse=True)
        sums = np.bincount(inv, weights=wts).astype(np.float32)
        return ((uniq // V).astype(np.int32), (uniq % V).astype(np.int32), sums)

    # -------------------------------------------------------------- training
    def fit(self, sentences: Optional[Corpus] = None, **_):
        it = self._as_iterator(sentences)

        def tokenized():
            it.reset()
            return self._tokenized(it)

        if self.vocab is None:
            self.build_vocab(tokenized())
        V, D = self.vocab.num_words(), self.layer_size
        rows, cols, x = self._cooccurrences(tokenized())
        if len(rows) == 0:
            raise ValueError("empty co-occurrence table — corpus too small")
        logx = np.log(x)
        weight = np.minimum(1.0, (x / self.x_max) ** self.alpha).astype(np.float32)
        rng = self._rng
        scale = 0.5 / D
        self.syn0 = self._tensor((rng.random((V, D), np.float32) - 0.5) * 2 * scale)
        self.syn0c = self._tensor((rng.random((V, D), np.float32) - 0.5) * 2 * scale)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        self.bias, self.bias_c = zeros(V), zeros(V)
        self._gw, self._gwc = zeros(V, D), zeros(V, D)
        self._gb, self._gbc = zeros(V), zeros(V)
        b = self.batch_size
        for _ in range(self.epochs):
            order = rng.permutation(len(rows)) if self.shuffle else np.arange(len(rows))
            losses = []
            for s in range(0, len(order), b):
                sel = order[s:s + b]
                r, _ = self._pad(rows[sel], b)
                c, _ = self._pad(cols[sel], b)
                lx, _ = self._pad(logx[sel], b)
                # padded entries carry weight 0: no gradient, no loss
                wt, _ = self._pad(weight[sel], b)
                (self.syn0, self.syn0c, self.bias, self.bias_c,
                 self._gw, self._gwc, self._gb, self._gbc, loss) = kernels.glove_step(
                    self.syn0, self.syn0c, self.bias, self.bias_c,
                    self._gw, self._gwc, self._gb, self._gbc,
                    *self._batch_tensors(r.astype(np.int32), c.astype(np.int32),
                                         lx.astype(np.float32), wt.astype(np.float32)),
                    self.learning_rate)
                losses.append(loss)
            # one host read per epoch, after all batches are queued
            self.loss_history.append(
                float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64)))
                if losses else 0.0)
        return self

    # ------------------------------------------------------------- accessors
    def word_vector(self, word: str) -> Optional[np.ndarray]:
        """GloVe's final vectors are main + context (W + W~)."""
        i = self.vocab.index_of(word) if self.vocab is not None else -1
        if i < 0 or self.syn0 is None:
            return None
        return self.syn0[i].cpu().numpy() + self.syn0c[i].cpu().numpy()

    def get_word_vector_matrix(self) -> np.ndarray:
        return self.syn0.cpu().numpy() + self.syn0c.cpu().numpy()
