"""UI internationalization (counterpart of ``deeplearning4j_tpu/ui/i18n.py``,
the same languages and messages).

Parity surface: reference ``deeplearning4j-ui-model/.../i18n/I18N.java`` +
``DefaultI18N.java`` (language-keyed message resources for the train UI,
``getMessage(key)``, default-language switching; the reference ships
translations for de/ja/ko/ru/zh next to en).

Served at ``/api/i18n?lang=xx`` by the UI server so clients can re-label
the dashboard; ``DefaultI18N.get_instance()`` mirrors the reference's
singleton access pattern.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

# message key -> per-language text. Keys follow the reference's
# train.-namespace naming.
_MESSAGES: Dict[str, Dict[str, str]] = {
    "en": {
        "train.pagetitle": "Training UI",
        "train.nav.overview": "Overview",
        "train.nav.model": "Model",
        "train.nav.system": "System",
        "train.nav.tsne": "t-SNE",
        "train.nav.activations": "Activations",
        "train.overview.chart.score": "Score vs iteration",
        "train.overview.chart.ratio": "Update : parameter ratio",
        "train.overview.perftable.title": "Performance",
        "train.model.paramhist": "Parameter histogram",
        "train.model.updatehist": "Update histogram",
        "train.system.memory": "Memory",
        "train.session": "Session",
        "train.parameter": "Parameter",
    },
    "de": {
        "train.pagetitle": "Trainings-UI",
        "train.nav.overview": "Übersicht",
        "train.nav.model": "Modell",
        "train.nav.system": "System",
        "train.nav.tsne": "t-SNE",
        "train.nav.activations": "Aktivierungen",
        "train.overview.chart.score": "Score über Iterationen",
        "train.overview.chart.ratio": "Update-Parameter-Verhältnis",
        "train.overview.perftable.title": "Leistung",
        "train.model.paramhist": "Parameter-Histogramm",
        "train.model.updatehist": "Update-Histogramm",
        "train.system.memory": "Speicher",
        "train.session": "Sitzung",
        "train.parameter": "Parameter",
    },
    "ja": {
        "train.pagetitle": "トレーニングUI",
        "train.nav.overview": "概要",
        "train.nav.model": "モデル",
        "train.nav.system": "システム",
        "train.nav.tsne": "t-SNE",
        "train.nav.activations": "活性化",
        "train.overview.chart.score": "スコア対イテレーション",
        "train.overview.chart.ratio": "更新・パラメータ比",
        "train.overview.perftable.title": "パフォーマンス",
        "train.model.paramhist": "パラメータヒストグラム",
        "train.model.updatehist": "更新ヒストグラム",
        "train.system.memory": "メモリ",
        "train.session": "セッション",
        "train.parameter": "パラメータ",
    },
    "zh": {
        "train.pagetitle": "训练界面",
        "train.nav.overview": "概览",
        "train.nav.model": "模型",
        "train.nav.system": "系统",
        "train.nav.tsne": "t-SNE",
        "train.nav.activations": "激活",
        "train.overview.chart.score": "得分与迭代",
        "train.overview.chart.ratio": "更新参数比",
        "train.overview.perftable.title": "性能",
        "train.model.paramhist": "参数直方图",
        "train.model.updatehist": "更新直方图",
        "train.system.memory": "内存",
        "train.session": "会话",
        "train.parameter": "参数",
    },
    "ko": {
        "train.pagetitle": "훈련 UI",
        "train.nav.overview": "개요",
        "train.nav.model": "모델",
        "train.nav.system": "시스템",
        "train.nav.tsne": "t-SNE",
        "train.nav.activations": "활성화",
        "train.overview.chart.score": "반복별 점수",
        "train.overview.chart.ratio": "업데이트-파라미터 비율",
        "train.overview.perftable.title": "성능",
        "train.model.paramhist": "파라미터 히스토그램",
        "train.model.updatehist": "업데이트 히스토그램",
        "train.system.memory": "메모리",
        "train.session": "세션",
        "train.parameter": "파라미터",
    },
    "ru": {
        "train.pagetitle": "Интерфейс обучения",
        "train.nav.overview": "Обзор",
        "train.nav.model": "Модель",
        "train.nav.system": "Система",
        "train.nav.tsne": "t-SNE",
        "train.nav.activations": "Активации",
        "train.overview.chart.score": "Оценка по итерациям",
        "train.overview.chart.ratio": "Отношение обновления к параметру",
        "train.overview.perftable.title": "Производительность",
        "train.model.paramhist": "Гистограмма параметров",
        "train.model.updatehist": "Гистограмма обновлений",
        "train.system.memory": "Память",
        "train.session": "Сессия",
        "train.parameter": "Параметр",
    },
}

FALLBACK_LANGUAGE = "en"


class DefaultI18N:
    """Singleton message source (reference DefaultI18N.java)."""

    _instance: Optional["DefaultI18N"] = None
    _lock = threading.Lock()

    def __init__(self):
        self._default = FALLBACK_LANGUAGE

    @classmethod
    def get_instance(cls) -> "DefaultI18N":
        # called from ThreadingHTTPServer request threads: creation must be
        # locked or a race can discard an already-configured instance
        if cls._instance is None:
            with cls._lock:
                if cls._instance is None:
                    cls._instance = cls()
        return cls._instance

    # ----------------------------------------------------------------- api
    def languages(self):
        return sorted(_MESSAGES)

    def get_default_language(self) -> str:
        return self._default

    def set_default_language(self, lang: str):
        if lang not in _MESSAGES:
            raise ValueError(f"Unknown language '{lang}' "
                             f"(have {self.languages()})")
        self._default = lang
        return self

    def get_message(self, key: str, lang: Optional[str] = None) -> str:
        """Message for key; falls back to English, then the key itself
        (reference getMessage fallback chain)."""
        lang = lang or self._default
        msgs = _MESSAGES.get(lang, {})
        if key in msgs:
            return msgs[key]
        return _MESSAGES[FALLBACK_LANGUAGE].get(key, key)

    def messages(self, lang: Optional[str] = None) -> Dict[str, str]:
        """Full message map with English fallback applied (serving payload
        of the UI server's /api/i18n route)."""
        lang = lang or self._default
        out = dict(_MESSAGES[FALLBACK_LANGUAGE])
        out.update(_MESSAGES.get(lang, {}))
        return out
