"""Sentence -> padded word-vector tensors for CNN text classification.

Parity surface: reference
``deeplearning4j-nlp/.../iterator/CnnSentenceDataSetIterator.java:47``
(builder: sentenceProvider, wordVectors, minibatchSize, maxSentenceLength,
unknownWordHandling REMOVE_WORD|USE_UNKNOWN, sentencesAlongHeight) and
``LabeledSentenceProvider``/``CollectionLabeledSentenceProvider``.

Counterpart of ``deeplearning4j_tpu/nlp/cnn_sentence.py``, the same
layout: the reference emits NCHW (b, 1, maxLen, vecSize); this framework
is NHWC, so batches are (b, maxLen, vecSize, 1) — time along
height, embedding along width, one channel — ready for ``ConvolutionLayer``
with ``InputType.convolutional(maxLen, vec_size, 1)``. Variable-length
sentences zero-pad on the right with a per-step feature mask (b, maxLen).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class CollectionLabeledSentenceProvider:
    """(sentence, label) pairs from lists (reference
    CollectionLabeledSentenceProvider.java)."""

    def __init__(self, sentences: Sequence[str], labels: Sequence[str],
                 seed: Optional[int] = None):
        if len(sentences) != len(labels):
            raise ValueError("sentences and labels must align")
        self._data = list(zip(sentences, labels))
        self._labels = sorted(set(labels))
        self._rng = None if seed is None else np.random.default_rng(seed)
        self.reset()

    def reset(self):
        self._order = list(range(len(self._data)))
        if self._rng is not None:
            self._rng.shuffle(self._order)
        self._pos = 0

    def has_next(self) -> bool:
        return self._pos < len(self._order)

    def next_sentence(self) -> Tuple[str, str]:
        s, l = self._data[self._order[self._pos]]
        self._pos += 1
        return s, l

    def all_labels(self) -> List[str]:
        return self._labels

    def num_labels(self) -> int:
        return len(self._labels)


class CnnSentenceDataSetIterator:
    """Batches of (b, maxLen, vec_size, 1) word-vector tensors + one-hot
    labels + right-pad feature masks (reference
    CnnSentenceDataSetIterator.java:47).

    ``word_vectors`` is anything with ``word_vector(word) -> np.ndarray |
    None`` (Word2Vec, SequenceVectors, loaded serializer models).
    ``unknown_word_handling``: "remove_word" drops OOV tokens (reference
    REMOVE_WORD); "use_unknown" substitutes ``unknown_word``'s vector."""

    def __init__(self, sentence_provider, word_vectors,
                 batch_size: int = 32, max_sentence_length: int = 64,
                 unknown_word_handling: str = "remove_word",
                 unknown_word: str = "UNK",
                 tokenizer_factory=None):
        from deeplearning4j_tpu_torch.nlp.tokenization import DefaultTokenizerFactory
        self.provider = sentence_provider
        self.word_vectors = word_vectors
        self.batch_size = batch_size
        self.max_sentence_length = max_sentence_length
        self.unknown_word_handling = unknown_word_handling
        self.unknown_word = unknown_word
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        probe = None
        for cand in ("the", "a"):
            probe = word_vectors.word_vector(cand)
            if probe is not None:
                break
        if probe is None:
            # fall back to any vector the model can produce
            mat = getattr(word_vectors, "get_word_vector_matrix", None)
            if mat is not None:
                probe = np.asarray(mat())[0]
        if probe is None:
            raise ValueError("word_vectors yields no vectors to size from")
        self.vec_size = int(np.asarray(probe).shape[-1])
        self._labels = list(self.provider.all_labels())
        self._lab_idx = {l: i for i, l in enumerate(self._labels)}

    # -------------------------------------------------------------- iterate
    def reset(self):
        self.provider.reset()

    def has_next(self) -> bool:
        return self.provider.has_next()

    def _vectors_for(self, sentence: str) -> np.ndarray:
        toks = self.tokenizer_factory.create(sentence).get_tokens()
        vecs = []
        for t in toks:
            v = self.word_vectors.word_vector(t)
            if v is None:
                if self.unknown_word_handling == "use_unknown":
                    v = self.word_vectors.word_vector(self.unknown_word)
                    if v is None:
                        v = np.zeros(self.vec_size, np.float32)
                else:           # remove_word
                    continue
            vecs.append(np.asarray(v, np.float32))
            if len(vecs) >= self.max_sentence_length:
                break
        if not vecs:
            vecs = [np.zeros(self.vec_size, np.float32)]
        return np.stack(vecs)

    def next(self, num: Optional[int] = None) -> DataSet:
        num = num or self.batch_size
        sents, labs = [], []
        while self.provider.has_next() and len(sents) < num:
            s, l = self.provider.next_sentence()
            sents.append(self._vectors_for(s))
            labs.append(self._lab_idx[l])
        if not sents:
            # NOT StopIteration: PEP 479 turns that into RuntimeError when
            # this is called inside a generator frame
            raise ValueError("sentence provider exhausted; reset() first")
        b = len(sents)
        T = max(v.shape[0] for v in sents)
        feats = np.zeros((b, T, self.vec_size, 1), np.float32)
        fmask = np.zeros((b, T), np.float32)
        for i, v in enumerate(sents):
            feats[i, : v.shape[0], :, 0] = v
            fmask[i, : v.shape[0]] = 1.0
        labels = np.eye(len(self._labels), dtype=np.float32)[labs]
        return DataSet(feats, labels, features_mask=fmask)

    def __iter__(self):
        self.reset()
        while self.has_next():
            yield self.next()

    # ------------------------------------------------------------- metadata
    def get_labels(self) -> List[str]:
        return self._labels

    def input_columns(self) -> int:
        return self.vec_size

    def total_outcomes(self) -> int:
        return len(self._labels)

    def load_single_sentence(self, sentence: str) -> np.ndarray:
        """One sentence -> (1, len, vec_size, 1) tensor (reference
        loadSingleSentence)."""
        v = self._vectors_for(sentence)
        return v[None, :, :, None]
