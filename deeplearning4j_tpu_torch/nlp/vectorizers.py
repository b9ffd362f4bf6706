"""Bag-of-words / TF-IDF text vectorizers.

Parity surface: reference
``deeplearning4j-nlp/.../bagofwords/vectorizer/BaseTextVectorizer.java``
(fit over an iterator: vocab + document frequencies),
``BagOfWordsVectorizer.java`` (transform -> raw count vector, vectorize ->
DataSet with one-hot label) and ``TfidfVectorizer.java:127``
(tfidfWord = (count/docLen) * log10(totalDocs/docFreq) — MathUtils.idf/tf).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.nlp.sentenceiterator import LabelledDocument
from deeplearning4j_tpu_torch.nlp.tokenization import (DefaultTokenizerFactory,
                                                 TokenizerFactory)
from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache, VocabWord

Corpus = Iterable[Union[str, LabelledDocument]]


class BaseTextVectorizer:
    """Shared fit machinery: vocabulary, document frequencies, labels."""

    def __init__(self, min_word_frequency: int = 1,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 stop_words: Sequence[str] = ()):
        self.min_word_frequency = min_word_frequency
        self.tokenizer = tokenizer_factory or DefaultTokenizerFactory()
        self.stop_words = set(stop_words)
        self.vocab: Optional[AbstractCache] = None
        self.labels: List[str] = []
        self._doc_freq: dict = {}
        self.total_docs = 0

    def _tokens(self, text: str) -> List[str]:
        toks = self.tokenizer.create(text).get_tokens()
        return [t for t in toks if t and t not in self.stop_words]

    @staticmethod
    def _doc(doc) -> tuple:
        if isinstance(doc, LabelledDocument):
            return doc.content, list(doc.labels)
        return doc, []

    def fit(self, corpus: Corpus) -> "BaseTextVectorizer":
        """Build vocabulary + per-word document frequencies (reference
        BaseTextVectorizer.buildVocab)."""
        from collections import Counter
        self._doc_freq = {}  # re-fit replaces, never mixes, corpora stats
        self.total_docs = 0
        counts: Counter = Counter()
        labels = []
        for doc in corpus:
            text, doc_labels = self._doc(doc)
            for lab in doc_labels:
                if lab not in labels:
                    labels.append(lab)
            toks = self._tokens(text)
            counts.update(toks)
            for t in set(toks):
                self._doc_freq[t] = self._doc_freq.get(t, 0) + 1
            self.total_docs += 1
        cache = AbstractCache()
        for word, n in counts.items():
            if n >= self.min_word_frequency:
                cache.add_token(VocabWord(word, n))
        cache.finalize_vocab()
        self.vocab = cache
        self.labels = labels
        return self

    def vocab_size(self) -> int:
        return 0 if self.vocab is None else self.vocab.num_words()

    def index_of(self, word: str) -> int:
        return self.vocab.index_of(word)

    def _counts(self, text: str):
        counts = {}
        n_tokens = 0
        for t in self._tokens(text):
            n_tokens += 1
            if self.vocab.contains_word(t):
                counts[t] = counts.get(t, 0) + 1
        return counts, n_tokens

    def transform(self, text: str) -> np.ndarray:
        raise NotImplementedError

    def vectorize(self, text: str, label: str) -> DataSet:
        """(features, one-hot label) pair (reference vectorize(String,String))."""
        x = self.transform(text).reshape(1, -1)
        y = np.zeros((1, max(len(self.labels), 1)), np.float32)
        if label in self.labels:
            y[0, self.labels.index(label)] = 1.0
        return DataSet(x, y)

    def fit_transform(self, corpus: Sequence) -> np.ndarray:
        self.fit(corpus)
        return np.stack([self.transform(self._doc(d)[0]) for d in corpus])


class BagOfWordsVectorizer(BaseTextVectorizer):
    """Raw term-count vectors (reference BagOfWordsVectorizer.java:76)."""

    def transform(self, text: str) -> np.ndarray:
        out = np.zeros(self.vocab_size(), np.float32)
        counts, _ = self._counts(text)
        for word, c in counts.items():
            out[self.vocab.index_of(word)] = c
        return out


class TfidfVectorizer(BaseTextVectorizer):
    """TF-IDF vectors (reference TfidfVectorizer.java:127):
    tf = count/docLength, idf = log10(totalDocs/docFreq)."""

    def idf(self, word: str) -> float:
        df = self._doc_freq.get(word, 0)
        if self.total_docs == 0 or df == 0:
            return 0.0
        return math.log10(self.total_docs / df)

    def tfidf(self, word: str, count: int, doc_length: int) -> float:
        tf = count / max(doc_length, 1)
        return tf * self.idf(word)

    def transform(self, text: str) -> np.ndarray:
        out = np.zeros(self.vocab_size(), np.float32)
        counts, n_tokens = self._counts(text)
        for word, c in counts.items():
            out[self.vocab.index_of(word)] = self.tfidf(word, c, n_tokens)
        return out
