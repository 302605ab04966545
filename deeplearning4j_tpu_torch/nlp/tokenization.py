"""Tokenizers + preprocessors.

The port's own copy of ``deeplearning4j_tpu/nlp/tokenization.py``
(pure Python, the same classes and behaviour). Reference:
`deeplearning4j-nlp-parent/deeplearning4j-nlp/src/main/java/org/
deeplearning4j/text/tokenization/` — `TokenizerFactory`,
`DefaultTokenizer`, `NGramTokenizerFactory`, `tokenizerfactory/`, and
`tokenization/tokenizer/preprocessor/CommonPreprocessor.java`.
"""
from __future__ import annotations

import re
from typing import Callable, Iterable, List, Optional


class TokenPreProcess:
    """Per-token normalization hook (reference TokenPreProcess.java)."""

    def pre_process(self, token: str) -> str:
        raise NotImplementedError


class CommonPreprocessor(TokenPreProcess):
    """Lowercase + strip punctuation/digits-adjacent symbols
    (reference preprocessor/CommonPreprocessor.java)."""

    _PUNCT = re.compile(r"[\d\.:,\"'\(\)\[\]|/?!;]+")

    def pre_process(self, token: str) -> str:
        return self._PUNCT.sub("", token).lower()


class LowCasePreProcessor(TokenPreProcess):
    def pre_process(self, token: str) -> str:
        return token.lower()


class EndingPreProcessor(TokenPreProcess):
    """Crude stemmer for plurals/gerunds (reference EndingPreProcessor.java)."""

    def pre_process(self, token: str) -> str:
        for end, rep in (("s", ""), ("ing", ""), ("ly", ""), ("ed", "")):
            if len(token) > len(end) + 2 and token.endswith(end):
                return token[: -len(end)]
        return token


class Tokenizer:
    """One document's token stream (reference Tokenizer.java)."""

    def __init__(self, tokens: List[str],
                 pre: Optional[TokenPreProcess] = None):
        self._tokens = tokens
        self._pre = pre
        self._i = 0

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre

    def has_more_tokens(self) -> bool:
        return self._i < len(self._tokens)

    def next_token(self) -> str:
        t = self._tokens[self._i]
        self._i += 1
        return self._pre.pre_process(t) if self._pre else t

    def count_tokens(self) -> int:
        return len(self._tokens)

    def get_tokens(self) -> List[str]:
        out = []
        while self.has_more_tokens():
            t = self.next_token()
            if t:
                out.append(t)
        return out


class TokenizerFactory:
    def create(self, text: str) -> Tokenizer:
        raise NotImplementedError

    def set_token_pre_processor(self, pre: TokenPreProcess):
        self._pre = pre


class DefaultTokenizerFactory(TokenizerFactory):
    """Whitespace tokenizer (reference DefaultTokenizerFactory.java)."""

    def __init__(self):
        self._pre: Optional[TokenPreProcess] = None

    def create(self, text: str) -> Tokenizer:
        return Tokenizer(text.split(), self._pre)


class NGramTokenizerFactory(TokenizerFactory):
    """Emits word n-grams from min_n..max_n (reference NGramTokenizerFactory)."""

    def __init__(self, min_n: int = 1, max_n: int = 2):
        self.min_n, self.max_n = min_n, max_n
        self._pre: Optional[TokenPreProcess] = None

    def create(self, text: str) -> Tokenizer:
        words = text.split()
        if self._pre:
            words = [w for w in (self._pre.pre_process(t) for t in words) if w]
        toks = []
        for n in range(self.min_n, self.max_n + 1):
            toks.extend(" ".join(words[i:i + n])
                        for i in range(len(words) - n + 1))
        return Tokenizer(toks, None)
