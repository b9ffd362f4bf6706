"""The embedding family of the JAX package's ``nlp/`` on PyTorch:
Word2Vec (skip-gram / CBOW x negative sampling / hierarchical softmax),
ParagraphVectors, GloVe and the generic SequenceVectors, with the
tokenizers, sentence iterators, vocabulary and word-vector serializer they
use. Every float segment-sum of their steps runs in the hand-written
``scatter_add`` kernel on the card (``perf/kernels/scatter_add.py``).

Not ported yet: the CJK tokenizers (``cjk.py``), the bag-of-words / TF-IDF
vectorizers (``vectorizers.py``) and ``CnnSentenceDataSetIterator``
(``cnn_sentence.py``)."""

from deeplearning4j_tpu_torch.nlp.tokenization import (
    CommonPreprocessor,
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.vocab import AbstractCache, VocabConstructor, VocabWord
from deeplearning4j_tpu_torch.nlp.sentenceiterator import (
    BasicLineIterator,
    CollectionSentenceIterator,
    LabelAwareIterator,
    LabelledDocument,
    SentenceIterator,
    SimpleLabelAwareIterator,
)
from deeplearning4j_tpu_torch.nlp.sequencevectors import SequenceVectors
from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
from deeplearning4j_tpu_torch.nlp.paragraphvectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.serializer import StaticWordVectors, WordVectorSerializer

__all__ = [
    "AbstractCache",
    "BasicLineIterator",
    "CollectionSentenceIterator",
    "CommonPreprocessor",
    "DefaultTokenizerFactory",
    "Glove",
    "LabelAwareIterator",
    "LabelledDocument",
    "NGramTokenizerFactory",
    "ParagraphVectors",
    "SentenceIterator",
    "SequenceVectors",
    "SimpleLabelAwareIterator",
    "StaticWordVectors",
    "TokenizerFactory",
    "VocabConstructor",
    "VocabWord",
    "Word2Vec",
    "WordVectorSerializer",
]
