"""SequenceVectors: the generic embedding trainer.

The JAX package's ``nlp/sequencevectors.py`` on PyTorch. The host path is
the same code: a vectorised numpy pass turns a chunk of index sequences
into (center, context) pairs or CBOW bags, with the **same calls to the
model's numpy ``Generator`` in the same order** (window radii, subsampling,
negatives, table init), so both packages train on the same pairs and
negatives from the same seed. Each batch then runs one step of
``kernels.py`` on the tables, which are tensors on the model's device.

The corpus-resident path (plain SGNS on a large corpus) keeps the encoded
corpus on the device, one segment of whole sentences at a time, and draws
each batch's pairs and shared negatives there with a ``torch.Generator``
seeded from ``seed``. The JAX package runs a static number of batches per
segment and masks those past the segment's quota (a static-shape need of
XLA); the port runs only the quota. Philox is not threefry: this path and
the host path's full macros of pairs (``_train_pairs_macro``) draw other
numbers than the JAX package does, and agree with it in distribution.

Every entry point runs on ``cuda`` unless ``device="cpu"`` is passed
(``device.py``). Lookups (``word_vector``, ``get_word_vector_matrix``)
return numpy, as in the JAX package.
"""

from __future__ import annotations

import itertools
from collections import Counter
from typing import Iterable, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nlp import kernels
from deeplearning4j_tpu_torch.nlp.vocab import (AbstractCache, VocabConstructor,
                                                build_huffman, unigram_table)


class SequenceVectors:
    """Train element embeddings over sequences.

    Keyword config as the JAX package's (reference SequenceVectors.Builder):
    layer_size, window_size, negative (0 => hierarchical softmax),
    learning_rate / min_learning_rate (linear decay), sampling, epochs,
    iterations, batch_size, min_word_frequency, use_cbow, seed,
    device_corpus; plus ``device``.

    ``counters`` counts what ran: ``corpus_segments`` (segment passes of the
    corpus-resident path), ``corpus_batches`` (its batches: three
    ``scatter_add`` launches each), ``batches`` (host-path steps)."""

    def __init__(self, layer_size: int = 100, window_size: int = 5,
                 negative: int = 5, use_hierarchic_softmax: Optional[bool] = None,
                 learning_rate: float = 0.025, min_learning_rate: float = 1e-4,
                 sampling: float = 0.0, epochs: int = 1, iterations: int = 1,
                 batch_size: int = 2048, min_word_frequency: int = 1,
                 use_cbow: bool = False, seed: int = 12345,
                 device_corpus: Optional[bool] = None, device=None):
        self.layer_size = layer_size
        self.window_size = window_size
        self.negative = negative
        self.use_hs = (negative == 0 if use_hierarchic_softmax is None
                       else use_hierarchic_softmax)
        self.learning_rate = learning_rate
        self.min_learning_rate = min_learning_rate
        self.sampling = sampling
        self.epochs = epochs
        self.iterations = iterations
        self.batch_size = batch_size
        self.min_word_frequency = min_word_frequency
        self.use_cbow = use_cbow
        self.seed = seed
        self.device_corpus = device_corpus
        self.device = resolve_device(device)

        self.vocab: Optional[AbstractCache] = None
        self.syn0: Optional[torch.Tensor] = None
        self.syn1: Optional[torch.Tensor] = None
        self._codes = self._points = self._lengths = None
        self._neg_table: Optional[np.ndarray] = None
        self._neg_table_dev = None
        self._gen: Optional[torch.Generator] = None
        self._rng = np.random.default_rng(seed)
        self.words_processed = 0
        self.loss_history: List[float] = []
        self.counters = Counter()  # lint: disable=DLT007 (fit's own record of what ran, read by its callers; not a served metric)

    # ------------------------------------------------------------ vocab/init
    def build_vocab(self, sequences: Iterable[List[str]]):
        self.vocab = VocabConstructor(self.min_word_frequency) \
            .build_joint_vocabulary([sequences])
        return self

    def _tensor(self, a) -> torch.Tensor:
        """A copy of a host array on the model's device (a table is updated
        in place, so it never shares the caller's memory)."""
        return torch.tensor(np.asarray(a), device=self.device)

    def _init_tables(self):
        v, d = self.vocab.num_words(), self.layer_size
        self.syn0 = self._tensor((self._rng.random((v, d), np.float32) - 0.5) / d)
        self.syn1 = torch.zeros((v, d), dtype=torch.float32, device=self.device)
        if self.use_hs:
            self._codes, self._points, self._lengths = build_huffman(self.vocab)
        if self.negative > 0:
            self._neg_table = unigram_table(self.vocab)
            self._neg_table_dev = None

    def _generator(self) -> torch.Generator:
        """The device draws' generator, seeded from ``seed`` once per model."""
        if self._gen is None:
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(self.seed)
        return self._gen

    def _neg_table_device(self) -> torch.Tensor:
        if self._neg_table_dev is None:
            self._neg_table_dev = self._tensor(self._neg_table.astype(np.int32))
        return self._neg_table_dev

    # --------------------------------------------------------- vectorization
    def _index_sequences(self, sequences: Iterable[List[str]]):
        """tokens -> index arrays, dropping OOV words."""
        widx = {vw.word: vw.index for vw in self.vocab.vocab_words()}
        for tokens in sequences:
            idx = [widx[t] for t in tokens if t in widx]
            if len(idx) >= 2:
                yield np.asarray(idx, np.int64)

    def _index_flat(self, sequences: Iterable[List[str]], widx=None):
        """(flat word ids, sentence ids) of a segment, OOV words and
        sentences left with < 2 tokens dropped."""
        if widx is None:
            widx = {vw.word: vw.index for vw in self.vocab.vocab_words()}
        seqs = [s if isinstance(s, list) else list(s) for s in sequences]
        lens = np.fromiter((len(s) for s in seqs), np.int64, count=len(seqs))
        flat = np.fromiter(
            map(widx.get, itertools.chain.from_iterable(seqs), itertools.repeat(-1)),
            np.int64, count=int(lens.sum()))
        sid = np.repeat(np.arange(len(seqs), dtype=np.int64), lens)
        ok = flat >= 0
        flat, sid = flat[ok], sid[ok]
        counts = np.bincount(sid, minlength=len(seqs))
        good = counts[sid] >= 2
        return flat[good], sid[good]

    def _keep_prob(self) -> np.ndarray:
        """Each word's subsampling keep-probability (word2vec formula)."""
        counts = np.array([vw.count for vw in self.vocab.vocab_words()], np.float64)
        freq = counts / counts.sum()
        t = self.sampling
        return np.minimum(1.0, np.sqrt(t / freq) + t / freq)

    def _subsample(self, flat, sid):
        """Frequent-word subsampling: drop words before pairing."""
        if not self.sampling:
            return flat, sid
        keep = self._rng.random(len(flat)) < self._keep_prob()[flat]
        return flat[keep], sid[keep]

    def _pairs_for_chunk(self, seqs: List[np.ndarray]):
        """(centers, contexts) of a chunk with the dynamic window: per-center
        radius uniform in [1, window]."""
        flat = np.concatenate(seqs)
        sid = np.repeat(np.arange(len(seqs)), [len(s) for s in seqs])
        flat, sid = self._subsample(flat, sid)
        n = len(flat)
        if n < 2:
            return (np.zeros(0, np.int64),) * 2
        r = self._rng.integers(1, self.window_size + 1, n)
        centers, contexts = [], []
        for d in range(1, self.window_size + 1):
            same = sid[:-d] == sid[d:]
            left = same & (d <= r[:-d])
            right = same & (d <= r[d:])
            centers.append(flat[:-d][left])
            contexts.append(flat[d:][left])
            centers.append(flat[d:][right])
            contexts.append(flat[:-d][right])
        return np.concatenate(centers), np.concatenate(contexts)

    def _bags_for_chunk(self, seqs: List[np.ndarray]):
        """CBOW bags: for each center, its (2*window) padded context bag."""
        flat = np.concatenate(seqs)
        sid = np.repeat(np.arange(len(seqs)), [len(s) for s in seqs])
        flat, sid = self._subsample(flat, sid)
        n = len(flat)
        w = self.window_size
        if n < 2:
            return (np.zeros(0, np.int64), np.zeros((0, 2 * w), np.int64),
                    np.zeros((0, 2 * w), np.float32))
        bags, mask = self._bags(flat, sid, self._rng.integers(1, w + 1, n))
        has_ctx = mask.sum(-1) > 0
        return flat[has_ctx], bags[has_ctx], mask[has_ctx]

    def _bags(self, flat, sid, r):
        n, w = len(flat), self.window_size
        bags = np.zeros((n, 2 * w), np.int64)
        mask = np.zeros((n, 2 * w), np.float32)
        col = 0
        for d in range(1, w + 1):
            for sign in (-1, 1):
                src = np.arange(n) + sign * d
                ok = (src >= 0) & (src < n)
                ok[ok] &= sid[src[ok]] == sid[ok.nonzero()[0]]
                ok &= d <= r
                bags[ok, col] = flat[src[ok]]
                mask[ok, col] = 1.0
                col += 1
        return bags, mask

    # -------------------------------------------------------------- training
    def _lr(self, total_expected: int) -> float:
        frac = min(1.0, self.words_processed / max(1, total_expected))
        return max(self.min_learning_rate, self.learning_rate * (1.0 - frac))

    def _pad(self, arr, b, fill=0):
        if len(arr) == b:
            return arr, None
        pad = b - len(arr)
        wmask = np.ones(b, np.float32)
        wmask[len(arr):] = 0.0
        widths = ((0, pad),) + ((0, 0),) * (arr.ndim - 1)
        return np.pad(arr, widths, constant_values=fill), wmask

    # full macros of NB x batch_size pairs draw their negatives on the device
    # (the JAX package's one scanned dispatch); the ragged tail takes the
    # per-batch path with host negatives
    _MACRO_NB = 8

    def _train_pairs_macro(self, centers, contexts, lr):
        b = self.batch_size
        macro = b * self._MACRO_NB
        n_macros = len(centers) // macro
        i32 = lambda a: self._tensor(a.astype(np.int32).reshape(-1, b))  # noqa: E731
        losses = []
        for m in range(n_macros):
            sl = slice(m * macro, (m + 1) * macro)
            self.syn0, self.syn1, ls = kernels.sgns_macro_step(
                self.syn0, self.syn1, self._neg_table_device(), i32(centers[sl]),
                i32(contexts[sl]), self._generator(), self.negative, lr)
            losses.append(ls)
            self.counters["batches"] += self._MACRO_NB
        return n_macros * macro, losses

    def _batch_tensors(self, *arrays):
        return [self._tensor(a) for a in arrays]

    def _hs_path(self, ce, wmask):
        codes = self._codes[ce]
        points = self._points[ce]
        lengths = (self._lengths[ce] * wmask).astype(np.int32)
        return codes, points, lengths

    def _train_pairs(self, centers, contexts, lr):
        """Pairs through the steps in batch_size slices; the ragged last
        slice pads with a zero mask. Losses stay on the device."""
        b = self.batch_size
        losses = []
        start = 0
        if self.negative > 0 and len(centers) >= b * self._MACRO_NB:
            start, macro_losses = self._train_pairs_macro(centers, contexts, lr)
            losses.extend(macro_losses)
        for s in range(start, len(centers), b):
            ce, ct = centers[s:s + b], contexts[s:s + b]
            ce, wmask = self._pad(ce, b)
            ct, _ = self._pad(ct, b)
            if wmask is None:
                wmask = np.ones(b, np.float32)
            if self.negative > 0:
                negs = self._neg_table[
                    self._rng.integers(0, len(self._neg_table),
                                       (b, self.negative))].astype(np.int32)
                self.syn0, self.syn1, loss = kernels.sgns_step(
                    self.syn0, self.syn1, *self._batch_tensors(
                        ce.astype(np.int32), ct.astype(np.int32), negs, wmask), lr)
            else:
                self.syn0, self.syn1, loss = kernels.hs_step(
                    self.syn0, self.syn1, *self._batch_tensors(
                        ct.astype(np.int32), *self._hs_path(ce, wmask)), lr)
            losses.append(loss)
            self.counters["batches"] += 1
        return losses

    def _train_bags(self, centers, bags, bmask, lr):
        b = self.batch_size
        losses = []
        for s in range(0, len(centers), b):
            ce, wmask = self._pad(centers[s:s + b], b)
            bg, _ = self._pad(bags[s:s + b], b)
            bm, _ = self._pad(bmask[s:s + b], b)
            if wmask is None:
                wmask = np.ones(b, np.float32)
            bag_t = self._batch_tensors(bg.astype(np.int32), bm.astype(np.float32))
            if self.negative > 0:
                negs = self._neg_table[
                    self._rng.integers(0, len(self._neg_table),
                                       (b, self.negative))].astype(np.int32)
                self.syn0, self.syn1, loss = kernels.cbow_step(
                    self.syn0, self.syn1, self._tensor(ce.astype(np.int32)), *bag_t,
                    *self._batch_tensors(negs, wmask), lr)
            else:
                self.syn0, self.syn1, loss = kernels.cbow_hs_step(
                    self.syn0, self.syn1,
                    *self._batch_tensors(*self._hs_path(ce, wmask)), *bag_t, lr)
            losses.append(loss)
            self.counters["batches"] += 1
        return losses

    # below this corpus size the host enumeration path runs (the device path
    # samples pairs, which needs enough batches to cover the corpus)
    _DEVICE_CORPUS_MIN_TOKENS = 50_000

    def fit(self, sequences, chunk_sentences: int = 512):
        """Train. ``sequences`` is a factory (callable or re-iterable) of
        token-list iterables.

        Plain SGNS skip-gram on a corpus of at least 50,000 in-vocab tokens
        (with ``sampling == 0``) takes the corpus-resident path;
        ``device_corpus=True/False`` forces it on or off."""
        seq_factory = sequences if callable(sequences) else (lambda: sequences)
        if self.vocab is None:
            self.build_vocab(seq_factory())
        if self.syn0 is None:
            self._init_tables()
        dev_capable = (self.negative > 0 and not self.use_cbow and not self.use_hs)
        if self.device_corpus and not dev_capable:
            raise ValueError(
                "device_corpus=True supports plain SGNS skip-gram only "
                "(negative > 0, no CBOW, no hierarchical softmax); this "
                f"config has negative={self.negative}, "
                f"use_cbow={self.use_cbow}, use_hs={self.use_hs}")
        use_dev = (self.device_corpus if self.device_corpus is not None
                   else (dev_capable and self.sampling == 0))
        if use_dev:
            if (self.device_corpus
                    or self.vocab.total_word_occurrences >= self._DEVICE_CORPUS_MIN_TOKENS):
                return self._fit_device_corpus(seq_factory)
            token_lists = [t for t in seq_factory()]
            seq_factory = (lambda lists=token_lists: lists)
        total = self.vocab.total_word_occurrences * self.epochs * self.iterations
        for _ in range(self.epochs):
            epoch_losses: List = []
            chunk: List[np.ndarray] = []
            for idx in self._index_sequences(seq_factory()):
                chunk.append(idx)
                if len(chunk) >= chunk_sentences:
                    self._fit_chunk(chunk, total, epoch_losses)
                    chunk = []
            if chunk:
                self._fit_chunk(chunk, total, epoch_losses)
            self._end_epoch(epoch_losses)
        return self

    def _end_epoch(self, epoch_losses):
        """One host read per epoch: the mean of the epoch's batch losses."""
        if epoch_losses:
            flat = torch.cat([torch.atleast_1d(loss) for loss in epoch_losses])
            self.loss_history.append(float(torch.mean(flat)))

    # segment size (tokens) of the corpus-resident path: whole sentences, at
    # most this many tokens, so the host indexes segment i+1 while the card
    # trains segment i
    _DEVICE_CORPUS_SEG_TOKENS = 98_304

    def _segment_token_lists(self, token_lists):
        """Greedy whole-sentence packing, never exceeding the budget."""
        budget = self._DEVICE_CORPUS_SEG_TOKENS
        seg, n = [], 0
        for t in token_lists:
            if seg and n + len(t) > budget:
                yield seg
                seg, n = [], 0
            seg.append(t)
            n += len(t)
        if seg:
            yield seg

    def _corpus_segments(self, seq_factory):
        """Lazily index and upload each segment: yields (corpus, sid, T,
        batches) with ``corpus`` / ``sid`` int32 tensors on the device and
        the segment's quota of ceil(T * (window + 1) / batch_size) batches,
        the expected pair count of the host enumeration (2 * E[r] = window
        + 1 pairs per position)."""
        widx = {vw.word: vw.index for vw in self.vocab.vocab_words()}
        for seg in self._segment_token_lists(seq_factory()):
            flat, sid = self._index_flat(seg, widx)
            if len(flat) < 2:
                continue
            T = len(flat)
            nvb = max(1, -(-(T * (self.window_size + 1)) // self.batch_size))
            yield (self._tensor(flat.astype(np.int32)),
                   self._tensor(sid.astype(np.int32)), T, nvb)

    def _train_corpus_segment(self, corpus, sid, nvb, lr, keep=None):
        """The segment's nvb batches: draws, then one SGNS step each.
        Returns the (nvb,) losses on the device."""
        gen = self._generator()
        neg = self._neg_table_device()
        cdf = kernels.offset_cdf(self.window_size, self.device)
        losses = []
        for _ in range(nvb):
            draws = kernels.corpus_draws(gen, corpus, sid, neg, cdf, self.batch_size,
                                         self.negative, keep)
            self.syn0, self.syn1, loss = kernels.sgns_corpus_step(
                self.syn0, self.syn1, *draws, lr)
            losses.append(loss)
        self.counters["corpus_segments"] += 1
        self.counters["corpus_batches"] += nvb
        return torch.stack(losses)

    def _fit_device_corpus(self, seq_factory):
        """Corpus-resident training: the first pass indexes and uploads the
        segments lazily (the factory is read one segment ahead of the card),
        later epochs reuse them. The only host read is the per-epoch loss."""
        if not callable(seq_factory):
            seq_factory = (lambda lists=seq_factory: lists)
        keep = (self._tensor(self._keep_prob().astype(np.float32)) if self.sampling
                else None)
        total_expected = (self.vocab.total_word_occurrences * self.epochs
                          * self.iterations)
        plan = None
        for _ in range(self.epochs):
            epoch_losses = []
            for _ in range(self.iterations):
                entries = self._corpus_segments(seq_factory) if plan is None else plan
                built = [] if plan is None else None
                for entry in entries:
                    corpus, sid, T, nvb = entry
                    epoch_losses.append(self._train_corpus_segment(
                        corpus, sid, nvb, self._lr(total_expected), keep))
                    self.words_processed += T
                    if built is not None:
                        built.append(entry)
                if built is not None:
                    plan = built
            self._end_epoch(epoch_losses)
        return self

    def _fit_chunk(self, chunk, total_expected, epoch_losses):
        for _ in range(self.iterations):
            lr = self._lr(total_expected)
            if self.use_cbow:
                centers, bags, bmask = self._bags_for_chunk(chunk)
                if len(centers):
                    epoch_losses.extend(self._train_bags(centers, bags, bmask, lr))
            else:
                centers, contexts = self._pairs_for_chunk(chunk)
                if len(centers):
                    epoch_losses.extend(self._train_pairs(centers, contexts, lr))
            self.words_processed += sum(len(s) for s in chunk)

    # -------------------------------------------------------------- lookups
    def word_vector(self, word: str) -> Optional[np.ndarray]:
        i = self.vocab.index_of(word)
        return None if i < 0 else self.syn0[i].cpu().numpy()

    def get_word_vector_matrix(self) -> np.ndarray:
        return self.syn0.cpu().numpy()

    def has_word(self, word: str) -> bool:
        return self.vocab is not None and self.vocab.contains_word(word)

    def similarity(self, a: str, b: str) -> float:
        """Cosine similarity (reference WordVectors.similarity)."""
        va, vb = self.word_vector(a), self.word_vector(b)
        if va is None or vb is None:
            return float("nan")
        denom = (np.linalg.norm(va) * np.linalg.norm(vb)) or 1e-12
        return float(va @ vb / denom)

    def words_nearest(self, word_or_vec, top_n: int = 10) -> List[str]:
        """Nearest words by cosine (reference wordsNearest)."""
        if isinstance(word_or_vec, str):
            v = self.word_vector(word_or_vec)
            exclude = {word_or_vec}
        else:
            v = np.asarray(word_or_vec, np.float32)
            exclude = set()
        if v is None:
            return []
        m = self.get_word_vector_matrix()
        norms = np.linalg.norm(m, axis=1) * (np.linalg.norm(v) or 1e-12)
        sims = (m @ v) / np.maximum(norms, 1e-12)
        out = []
        for i in np.argsort(-sims):
            w = self.vocab.word_at_index(int(i))
            if w not in exclude:
                out.append(w)
            if len(out) >= top_n:
                break
        return out
