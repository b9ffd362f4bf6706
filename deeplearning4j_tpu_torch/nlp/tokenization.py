"""Tokenizer SPI.

Parity surface: reference ``text/tokenization/tokenizerfactory/
TokenizerFactory.java:31`` (SPI: create(String) -> Tokenizer with an optional
TokenPreProcess), DefaultTokenizerFactory, NGramTokenizerFactory, and
``text/tokenization/tokenizer/preprocessor/CommonPreprocessor.java``.

Pure host-side code (tokenization never touches the device).

The PyTorch port's own copy of ``deeplearning4j_tpu/nlp/tokenization.py`` (pure Python,
no tensors), kept line for line so that both packages read and tokenize a
corpus the same way."""

from __future__ import annotations

import re
from typing import Callable, Iterable, List, Optional


class TokenPreProcess:
    """reference tokenizer/TokenPreProcess.java."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits-adjacent junk (reference
    CommonPreprocessor.java: replaceAll punctuation, toLowerCase)."""

    _PUNCT = re.compile(r"[\d.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token).lower()


class LowCasePreprocessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class Tokenizer:
    """reference tokenizer/Tokenizer.java — iterator over tokens."""

    def __init__(self, tokens: List[str], pre: Optional[TokenPreProcess] = None):
        if pre is not None:
            tokens = [pre.pre_process(t) for t in tokens]
        self._tokens = [t for t in tokens if t]

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        return list(self._tokens)

    def __iter__(self):
        return iter(self._tokens)


class TokenizerFactory:
    """SPI base (reference TokenizerFactory.java:31)."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre
        return self

    def get_token_pre_processor(self) -> Optional[TokenPreProcess]:
        return self._pre

    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer (reference DefaultTokenizerFactory.java wraps a
    StringTokenizer on whitespace)."""

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text.split(), self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """Word n-grams over a base tokenizer (reference
    NGramTokenizerFactory.java)."""

    def __init__(self, base: Optional[TokenizerFactory] = None,
                 min_n: int = 1, max_n: int = 2):
        super().__init__()
        self._base = base or DefaultTokenizerFactory()
        self.min_n = min_n
        self.max_n = max_n

    def create(self, text: str) -> Tokenizer:
        words = self._base.create(text).get_tokens()
        out = []
        for n in range(self.min_n, self.max_n + 1):
            for i in range(len(words) - n + 1):
                out.append(" ".join(words[i:i + n]))
        return Tokenizer(out, self._pre)
