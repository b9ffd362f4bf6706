"""Vocabulary construction + Huffman coding.

Parity surface: reference ``models/word2vec/wordstore/VocabConstructor.java:31``
(parallel corpus scan -> joint vocabulary with min-frequency pruning),
``models/word2vec/wordstore/inmemory/AbstractCache.java`` (the VocabCache),
and ``models/sequencevectors/graph/huffman/`` + ``models/word2vec/Huffman.java``
(binary Huffman tree assigning codes/points for hierarchical softmax).

Host-side; the outputs consumed on-device are dense numpy tables
(codes/points padded to max code length, unigram negative-sampling table).

The PyTorch port's own copy of ``deeplearning4j_tpu/nlp/vocab.py`` (pure Python,
no tensors), kept line for line so that both packages build the same
vocabulary, codes and tables."""

from __future__ import annotations

import heapq
from collections import Counter
from typing import Dict, Iterable, List, Optional

import numpy as np


class VocabWord:
    """reference models/word2vec/VocabWord.java — a vocab element with
    frequency and Huffman code/point arrays."""

    __slots__ = ("word", "count", "index", "codes", "points")

    def __init__(self, word: str, count: int = 1):
        self.word = word
        self.count = count
        self.index = -1
        self.codes: List[int] = []
        self.points: List[int] = []

    def __repr__(self):
        return f"VocabWord({self.word!r}, n={self.count}, i={self.index})"


class AbstractCache:
    """In-memory vocab cache (reference inmemory/AbstractCache.java):
    word <-> index <-> VocabWord lookups plus total counts."""

    def __init__(self):
        self._words: Dict[str, VocabWord] = {}
        self._by_index: List[VocabWord] = []
        self.total_word_occurrences = 0

    # --- construction ---
    def add_token(self, vw: VocabWord):
        if vw.word in self._words:
            self._words[vw.word].count += vw.count
        else:
            self._words[vw.word] = vw

    def finalize_vocab(self):
        """Assign indices by descending frequency (the reference sorts the
        vocab for the unigram table and Huffman build)."""
        self._by_index = sorted(self._words.values(),
                                key=lambda w: (-w.count, w.word))
        for i, vw in enumerate(self._by_index):
            vw.index = i
        self.total_word_occurrences = sum(w.count for w in self._by_index)

    # --- lookups (reference VocabCache API) ---
    def num_words(self) -> int:
        return len(self._by_index)

    def contains_word(self, word: str) -> bool:
        return word in self._words

    def word_frequency(self, word: str) -> int:
        vw = self._words.get(word)
        return 0 if vw is None else vw.count

    def index_of(self, word: str) -> int:
        vw = self._words.get(word)
        return -1 if vw is None else vw.index

    def word_at_index(self, index: int) -> Optional[str]:
        if 0 <= index < len(self._by_index):
            return self._by_index[index].word
        return None

    def word_for(self, word: str) -> Optional[VocabWord]:
        return self._words.get(word)

    def vocab_words(self) -> List[VocabWord]:
        return list(self._by_index)

    def words(self) -> List[str]:
        return [w.word for w in self._by_index]


class VocabConstructor:
    """Corpus scan -> vocabulary (reference VocabConstructor.java:31).

    The reference runs parallel VocabRunnables per source; here one vectorized
    Counter pass per source achieves the same joint vocabulary."""

    def __init__(self, min_word_frequency: int = 1):
        self.min_word_frequency = min_word_frequency

    def build_joint_vocabulary(self, sources: Iterable[Iterable[List[str]]]) -> AbstractCache:
        counts: Counter = Counter()
        for source in sources:
            for tokens in source:
                counts.update(tokens)
        cache = AbstractCache()
        for word, n in counts.items():
            if n >= self.min_word_frequency:
                cache.add_token(VocabWord(word, n))
        cache.finalize_vocab()
        return cache


def build_huffman(cache: AbstractCache, max_code_length: int = 40):
    """Binary Huffman tree over word frequencies (reference Huffman.java /
    GraphHuffman.java): fills each VocabWord's codes (0/1 branch decisions)
    and points (inner-node indices root->leaf).

    Returns dense (codes, points, lengths) numpy arrays padded to the max
    actual code length — the device-side hierarchical softmax consumes these
    with a validity mask instead of per-word ragged loops."""
    n = cache.num_words()
    if n == 0:
        return (np.zeros((0, 1), np.int32), np.zeros((0, 1), np.int32),
                np.zeros((0,), np.int32))
    heap = [(vw.count, i, None, None) for i, vw in enumerate(cache.vocab_words())]
    heapq.heapify(heap)
    next_id = n
    parent: Dict[int, tuple] = {}  # node id -> (parent inner id, branch bit)
    while len(heap) > 1:
        c1, id1, _, _ = heapq.heappop(heap)
        c2, id2, _, _ = heapq.heappop(heap)
        inner = next_id
        next_id += 1
        parent[id1] = (inner, 0)
        parent[id2] = (inner, 1)
        heapq.heappush(heap, (c1 + c2, inner, None, None))
    root = heap[0][1] if heap else None
    for i, vw in enumerate(cache.vocab_words()):
        codes, points = [], []
        node = i
        while node != root and node in parent:
            inner, bit = parent[node]
            codes.append(bit)
            # inner-node row in syn1: inner ids start at n
            points.append(inner - n)
            node = inner
        codes.reverse()
        points.reverse()
        if len(codes) > max_code_length:
            raise ValueError(f"Huffman code longer than {max_code_length}")
        vw.codes = codes
        vw.points = points
    max_len = max((len(vw.codes) for vw in cache.vocab_words()), default=1) or 1
    codes_arr = np.zeros((n, max_len), np.int32)
    points_arr = np.zeros((n, max_len), np.int32)
    lengths = np.zeros((n,), np.int32)
    for i, vw in enumerate(cache.vocab_words()):
        L = len(vw.codes)
        lengths[i] = L
        codes_arr[i, :L] = vw.codes
        points_arr[i, :L] = vw.points
    return codes_arr, points_arr, lengths


def unigram_table(cache: AbstractCache, table_size: int = 100_000,
                  power: float = 0.75) -> np.ndarray:
    """Negative-sampling table: word index repeated proportional to
    count^0.75 (reference InMemoryLookupTable.resetWeights / makeTable)."""
    counts = np.array([vw.count for vw in cache.vocab_words()], np.float64)
    if counts.size == 0:
        return np.zeros((table_size,), np.int32)
    probs = counts ** power
    probs /= probs.sum()
    reps = np.maximum(1, np.round(probs * table_size)).astype(np.int64)
    table = np.repeat(np.arange(len(counts), dtype=np.int32), reps)
    if len(table) < table_size:
        table = np.concatenate([table, np.full(table_size - len(table),
                                               len(counts) - 1, np.int32)])
    return table[:table_size]
