"""Lightweight CJK tokenizers behind the TokenizerFactory SPI.

Parity surface: the reference bundles full tokenizer stacks for Chinese
(deeplearning4j-nlp-chinese ChineseTokenizer.java:1 /
ChineseTokenizerFactory.java, wrapping ansj), Japanese
(deeplearning4j-nlp-japanese, a kuromoji fork, ~55 files) and Korean
(deeplearning4j-nlp-korean, open-korean-text) — all exposed through the same
TokenizerFactory SPI as the default whitespace tokenizer.

These are deliberately lightweight, dependency-free equivalents that make
zh/ja/ko corpora *trainable* end-to-end (Word2Vec/ParagraphVectors/BoW):

* ``ChineseTokenizerFactory`` — forward-maximum-match over a bundled lexicon
  of frequent words (user-extensible), single-character fallback. FMM is the
  classic dictionary segmentation baseline (what ansj's core does before its
  statistical re-ranking).
* ``JapaneseTokenizerFactory`` — script-class segmentation (kanji/hiragana/
  katakana/latin/digit runs) with greedy particle splitting inside hiragana
  runs; the standard dictionary-free baseline for kana/kanji text.
* ``KoreanTokenizerFactory`` — whitespace eojeol splitting plus josa
  (particle) stripping, emitting stem and particle as separate tokens the
  way open-korean-text's stemmed tokens do.

All three accept the SPI's TokenPreProcess; Latin/digit runs embedded in CJK
text fall back to whitespace/word tokenization so mixed corpora work.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Set

from deeplearning4j_tpu_torch.nlp.tokenization import Tokenizer, TokenizerFactory

# ----------------------------------------------------------------- Chinese

# Frequent multi-character words (subset of any standard frequency list —
# the bundled seed keeps common NLP/news vocabulary segmentable; extend per
# corpus via the constructor).
_ZH_LEXICON = """
我们 你们 他们 她们 自己 什么 没有 可以 知道 现在 时候 这个 那个 这些 那些
因为 所以 但是 如果 虽然 还是 就是 不是 一个 很多 非常 已经 开始 进行 工作
学习 生活 问题 中国 北京 上海 世界 国家 政府 经济 发展 社会 文化 历史 科学
技术 计算 计算机 电脑 网络 互联网 数据 人工 智能 人工智能 机器 学习 机器学习
深度 深度学习 神经 网络 神经网络 模型 训练 语言 自然 处理 自然语言 研究 大学
老师 学生 朋友 家庭 父母 孩子 今天 明天 昨天 时间 地方 东西 事情 方法 方面
重要 主要 需要 应该 能够 希望 觉得 认为 表示 通过 对于 关于 根据 由于 为了
以及 或者 并且 而且 然后 于是 公司 企业 市场 产品 服务 用户 系统 信息 软件
硬件 程序 代码 算法 分析 设计 开发 测试 应用 平台 环境 资源 管理 项目 团队
喜欢 快乐 高兴 美丽 漂亮 好吃 天气 音乐 电影 图书 读书 旅游 运动 健康 医生
医院 城市 农村 交通 汽车 飞机 火车 地铁 食物 水果 蔬菜 米饭 面条 咖啡 牛奶
""".split()

_CJK_RUN_RE = re.compile(r"[一-鿿㐀-䶿]+")
_WORD_RE = re.compile(r"[A-Za-z0-9_]+|[^\sA-Za-z0-9_]")


class ChineseTokenizerFactory(TokenizerFactory):
    """Forward-maximum-match segmentation (reference
    ChineseTokenizerFactory.java surface). ``lexicon`` adds words to the
    bundled list (``extend=False`` replaces it); the FMM window adapts to
    the longest lexicon entry."""

    def __init__(self, lexicon: Optional[Iterable[str]] = None,
                 extend: bool = True):
        super().__init__()
        words: Set[str] = set(_ZH_LEXICON) if (lexicon is None or extend) \
            else set()
        if lexicon is not None:
            words.update(lexicon)
        self._lex = words
        self._max_len = max((len(w) for w in words), default=1)

    def _segment_cjk(self, run: str) -> List[str]:
        out, i, n = [], 0, len(run)
        while i < n:
            for ln in range(min(self._max_len, n - i), 1, -1):
                if run[i:i + ln] in self._lex:
                    out.append(run[i:i + ln])
                    i += ln
                    break
            else:
                out.append(run[i])  # single-char fallback
                i += 1
        return out

    def create(self, text: str) -> Tokenizer:
        tokens: List[str] = []
        for chunk in text.split():
            i = 0
            for m in _CJK_RUN_RE.finditer(chunk):
                if m.start() > i:
                    tokens.extend(_WORD_RE.findall(chunk[i:m.start()]))
                tokens.extend(self._segment_cjk(m.group()))
                i = m.end()
            if i < len(chunk):
                tokens.extend(_WORD_RE.findall(chunk[i:]))
        return Tokenizer(tokens, self._pre)


# ---------------------------------------------------------------- Japanese

_JA_PARTICLES = sorted(
    ["から", "まで", "より", "ので", "のに", "けど", "でも", "だけ", "ほど",
     "など", "は", "が", "を", "に", "で", "と", "も", "の", "へ", "や",
     "ね", "よ", "か", "な"], key=len, reverse=True)


def _script(ch: str) -> str:
    o = ord(ch)
    if 0x4E00 <= o <= 0x9FFF or 0x3400 <= o <= 0x4DBF or ch in "々〆ヶ":
        return "kanji"
    if 0x3040 <= o <= 0x309F:
        return "hira"
    if 0x30A0 <= o <= 0x30FF or o == 0xFF70 or 0xFF66 <= o <= 0xFF9D:
        return "kata"
    if ch.isdigit():
        return "digit"
    if ch.isalpha():
        return "latin"
    return "other"


class JapaneseTokenizerFactory(TokenizerFactory):
    """Script-transition segmentation with greedy particle splitting
    (reference deeplearning4j-nlp-japanese kuromoji-fork surface). The
    long-vowel mark and small kana stay attached to katakana runs; hiragana
    runs are split on the particle list so content words separate from
    function words."""

    def _split_hira(self, run: str) -> List[str]:
        out, i, n = [], 0, len(run)
        while i < n:
            for p in _JA_PARTICLES:
                if run.startswith(p, i):
                    out.append(p)
                    i += len(p)
                    break
            else:
                # consume up to the next particle start as one token
                j = i + 1
                while j < n and not any(run.startswith(p, j)
                                        for p in _JA_PARTICLES):
                    j += 1
                out.append(run[i:j])
                i = j
        return out

    def create(self, text: str) -> Tokenizer:
        tokens: List[str] = []
        run, cls = "", None
        def flush():
            if not run:
                return
            if cls == "hira":
                tokens.extend(self._split_hira(run))
            elif cls != "other":
                tokens.append(run)
            else:
                tokens.extend(t for t in _WORD_RE.findall(run)
                              if not t.isspace())
        for ch in text:
            c = _script(ch)
            # long-vowel mark / iteration marks extend the current run
            if ch in "ーゝゞヽヾ" and run:
                run += ch
                continue
            if c == cls:
                run += ch
            else:
                flush()
                run, cls = ch, c
        flush()
        return Tokenizer([t for t in tokens if t.strip()], self._pre)


# ------------------------------------------------------------------ Korean

_KO_JOSA = sorted(
    ["에서는", "에서도", "으로는", "으로도", "부터", "까지", "에서", "에게",
     "으로", "라는", "이라는", "은", "는", "이", "가", "을", "를", "의",
     "에", "로", "와", "과", "도", "만", "께", "야"], key=len, reverse=True)


def _is_hangul(ch: str) -> bool:
    return 0xAC00 <= ord(ch) <= 0xD7A3 or 0x1100 <= ord(ch) <= 0x11FF


class KoreanTokenizerFactory(TokenizerFactory):
    """Whitespace eojeol splitting + josa stripping (reference
    deeplearning4j-nlp-korean open-korean-text surface): '학교에서' ->
    ['학교', '에서']. Particles only split when a Hangul stem of 2+
    syllables remains, which avoids mangling short words."""

    def __init__(self, emit_josa: bool = True):
        super().__init__()
        self.emit_josa = emit_josa

    def _split_eojeol(self, w: str) -> List[str]:
        if not all(_is_hangul(c) for c in w):
            return [t for t in _WORD_RE.findall(w)]
        for josa in _KO_JOSA:
            if w.endswith(josa) and len(w) - len(josa) >= 2:
                stem = w[:-len(josa)]
                return [stem, josa] if self.emit_josa else [stem]
        return [w]

    def create(self, text: str) -> Tokenizer:
        tokens: List[str] = []
        for w in text.split():
            tokens.extend(self._split_eojeol(w))
        return Tokenizer(tokens, self._pre)


__all__ = ["ChineseTokenizerFactory", "JapaneseTokenizerFactory",
           "KoreanTokenizerFactory"]
