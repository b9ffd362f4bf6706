"""Word2Vec façade (the JAX package's ``nlp/word2vec.py`` on PyTorch).

Parity surface: reference ``models/word2vec/Word2Vec.java:45`` (extends
SequenceVectors; Builder wires a SentenceIterator + TokenizerFactory into
sequence production) with learning impls ``SkipGram.java:156`` /
``CBOW.java``. Word2Vec IS a SequenceVectors whose sequences come from
tokenized sentences; the steps are ``kernels.py``'s, on ``device``
(``cuda`` unless ``device="cpu"`` is passed)."""

from __future__ import annotations

from typing import Iterable, Optional, Union

from deeplearning4j_tpu_torch.nlp.sentenceiterator import (
    CollectionSentenceIterator, SentenceIterator,
)
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.tokenization import (
    DefaultTokenizerFactory, TokenizerFactory,
)

Corpus = Union[SentenceIterator, Iterable[str]]


class Word2Vec(SequenceVectors):
    """SkipGram/CBOW word embeddings over sentences.

    Mirrors the reference Builder surface: ``min_word_frequency``,
    ``iterations``, ``epochs``, ``layer_size``, ``window_size``, ``negative``
    (0 selects hierarchical softmax, as the reference's
    ``useHierarchicSoftmax(true).negativeSample(0)`` combo), ``sampling``,
    ``learning_rate``/``min_learning_rate``, ``use_cbow`` (reference
    ``elementsLearningAlgorithm(new CBOW<>())``), ``seed``, plus
    ``tokenizer_factory`` and ``sentence_iterator`` (reference
    ``.iterate(iter).tokenizerFactory(t)``)."""

    def __init__(self, sentence_iterator: Optional[Corpus] = None,
                 tokenizer_factory: Optional[TokenizerFactory] = None,
                 **kwargs):
        super().__init__(**kwargs)
        self.tokenizer_factory = tokenizer_factory or DefaultTokenizerFactory()
        self.sentence_iterator = sentence_iterator

    # ------------------------------------------------------------ sequences
    def _as_iterator(self, corpus: Optional[Corpus]) -> SentenceIterator:
        corpus = corpus if corpus is not None else self.sentence_iterator
        if corpus is None:
            raise ValueError(
                "no corpus: pass sentences to fit() or set sentence_iterator")
        if isinstance(corpus, SentenceIterator):
            return corpus
        return CollectionSentenceIterator(list(corpus))

    def _tokenized(self, it: SentenceIterator):
        tf = self.tokenizer_factory
        if type(tf) is DefaultTokenizerFactory and tf._pre is None:
            # plain whitespace split: skip the per-sentence Tokenizer object
            # churn (measured ~40% of the word2vec host budget)
            for sentence in it:
                tokens = sentence.split()
                if tokens:
                    yield tokens
            return
        for sentence in it:
            tokens = tf.create(sentence).get_tokens()
            if tokens:
                yield tokens

    # -------------------------------------------------------------- training
    def fit(self, sentences: Optional[Corpus] = None, **kwargs):
        """Build vocab (if needed) and train. ``sentences`` may be raw
        strings, a SentenceIterator, or omitted to use the constructor's
        iterator (reference Word2Vec.fit())."""
        it = self._as_iterator(sentences)

        def factory():
            it.reset()
            return self._tokenized(it)

        return super().fit(factory, **kwargs)

    # ------------------------------------------------------------- accessors
    def vocab_size(self) -> int:
        return 0 if self.vocab is None else self.vocab.num_words()
