"""Sentence / document iterators.

Parity surface: reference ``text/sentenceiterator/`` (SentenceIterator SPI,
BasicLineIterator, CollectionSentenceIterator, SentencePreProcessor) and
``text/documentiterator/`` (LabelledDocument, LabelAwareIterator,
LabelsSource) used by ParagraphVectors.

Pure host-side code. Iterators are restartable via ``reset()`` — the trainers
make multiple epochs over the corpus, mirroring the reference's
``iterator.reset()`` calls in SequenceVectors.fit.

The PyTorch port's own copy of ``deeplearning4j_tpu/nlp/sentenceiterator.py`` (pure Python,
no tensors), kept line for line so that both packages read and tokenize a
corpus the same way."""

from __future__ import annotations

from typing import Callable, Iterable, List, Optional


class SentencePreProcessor:
    """reference sentenceiterator/SentencePreProcessor.java."""

    def pre_process(self, sentence: str) -> str:
        raise NotImplementedError


class SentenceIterator:
    """SPI (reference SentenceIterator.java): nextSentence/hasNext/reset."""

    def __init__(self, pre: Optional[SentencePreProcessor] = None):
        self._pre = pre

    def set_pre_processor(self, pre: SentencePreProcessor):
        self._pre = pre
        return self

    def _apply(self, s: str) -> str:
        return self._pre.pre_process(s) if self._pre is not None else s

    def reset(self):
        raise NotImplementedError

    def __iter__(self) -> Iterable[str]:
        raise NotImplementedError


class CollectionSentenceIterator(SentenceIterator):
    """In-memory list of sentences (reference CollectionSentenceIterator.java)."""

    def __init__(self, sentences: List[str],
                 pre: Optional[SentencePreProcessor] = None):
        super().__init__(pre)
        self._sentences = list(sentences)

    def reset(self):
        pass

    def __iter__(self):
        for s in self._sentences:
            yield self._apply(s)


class BasicLineIterator(SentenceIterator):
    """One sentence per line from a file (reference BasicLineIterator.java)."""

    def __init__(self, path: str, pre: Optional[SentencePreProcessor] = None,
                 encoding: str = "utf-8"):
        super().__init__(pre)
        self.path = path
        self.encoding = encoding

    def reset(self):
        pass

    def __iter__(self):
        with open(self.path, "r", encoding=self.encoding) as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    yield self._apply(line)


class LabelledDocument:
    """reference documentiterator/LabelledDocument.java — content + labels."""

    def __init__(self, content: str, labels: Optional[List[str]] = None):
        self.content = content
        self.labels = list(labels or [])

    def __repr__(self):
        return f"LabelledDocument(labels={self.labels!r})"


class LabelAwareIterator:
    """SPI (reference documentiterator/LabelAwareIterator.java)."""

    def reset(self):
        raise NotImplementedError

    def __iter__(self) -> Iterable[LabelledDocument]:
        raise NotImplementedError


class SimpleLabelAwareIterator(LabelAwareIterator):
    """Wraps a list of LabelledDocuments (reference
    SimpleLabelAwareIterator.java)."""

    def __init__(self, documents: List[LabelledDocument]):
        self._docs = list(documents)

    def reset(self):
        pass

    def __iter__(self):
        return iter(self._docs)


class LabelAwareListSentenceIterator(LabelAwareIterator):
    """Sentences auto-labelled DOC_0, DOC_1, … (reference LabelsSource's
    generated labels + LabelAwareListSentenceIterator)."""

    def __init__(self, sentences: List[str], template: str = "DOC_%d"):
        self._docs = [LabelledDocument(s, [template % i])
                      for i, s in enumerate(sentences)]

    def reset(self):
        pass

    def __iter__(self):
        return iter(self._docs)
