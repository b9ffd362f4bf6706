"""The embedding family of the JAX package's ``nlp/`` on PyTorch:
Word2Vec (skip-gram / CBOW x negative sampling / hierarchical softmax),
ParagraphVectors, GloVe and the generic SequenceVectors, with the
tokenizers, sentence iterators, vocabulary and word-vector serializer they
use. Every float segment-sum of their steps runs in the hand-written
``scatter_add`` kernel on the card (``perf/kernels/scatter_add.py``).

Around them, host code copied from the JAX package: the dependency-free
Chinese / Japanese / Korean tokenizer factories (``cjk.py``), the
bag-of-words and TF-IDF vectorizers (``vectorizers.py``) and
``CnnSentenceDataSetIterator`` (``cnn_sentence.py``), which lays sentences
out as (b, T, vector, 1) batches with a per-step feature mask."""

from deeplearning4j_tpu_torch.nlp.tokenization import (
    CommonPreprocessor,
    DefaultTokenizerFactory,
    NGramTokenizerFactory,
    TokenizerFactory,
)
from deeplearning4j_tpu_torch.nlp.cjk import (
    ChineseTokenizerFactory,
    JapaneseTokenizerFactory,
    KoreanTokenizerFactory,
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
from deeplearning4j_tpu_torch.nlp.cnn_sentence import (
    CnnSentenceDataSetIterator, CollectionLabeledSentenceProvider,
)
from deeplearning4j_tpu_torch.nlp.paragraphvectors import ParagraphVectors
from deeplearning4j_tpu_torch.nlp.glove import Glove
from deeplearning4j_tpu_torch.nlp.serializer import StaticWordVectors, WordVectorSerializer
from deeplearning4j_tpu_torch.nlp.vectorizers import (
    BagOfWordsVectorizer,
    BaseTextVectorizer,
    TfidfVectorizer,
)

__all__ = [
    "AbstractCache",
    "BagOfWordsVectorizer",
    "BaseTextVectorizer",
    "BasicLineIterator",
    "ChineseTokenizerFactory",
    "JapaneseTokenizerFactory",
    "KoreanTokenizerFactory",
    "CollectionLabeledSentenceProvider",
    "CollectionSentenceIterator",
    "CnnSentenceDataSetIterator",
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
    "TfidfVectorizer",
    "TokenizerFactory",
    "VocabConstructor",
    "VocabWord",
    "Word2Vec",
    "WordVectorSerializer",
]
