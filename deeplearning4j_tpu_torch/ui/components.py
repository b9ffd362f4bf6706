"""Standalone UI component/report library (counterpart of
``deeplearning4j_tpu/ui/components.py``: the same components, JSON and HTML).

Parity surface: reference ``deeplearning4j-ui-parent/deeplearning4j-ui-components``
(Component hierarchy: ChartHistogram, ChartHorizontalBar, ChartLine,
ChartScatter, ChartStackedArea, ChartTimeline, ComponentDiv, ComponentTable,
ComponentText, DecoratorAccordion; Style/StyleChart/StyleTable/StyleText;
each component serializes to JSON and renders client-side).

Design: same component model and JSON serde, but rendering is
SERVER-side self-contained SVG/HTML (the training hosts have no egress, so
no D3 bundle) — ``render_html()`` on any component, or
``render_page(components)`` for a full standalone report page. JSON
round-trips via ``to_dict``/``component_from_dict`` so reports can be
stored/shipped like the reference's serialized components.
"""

from __future__ import annotations

import dataclasses
import html as _html
import json
from typing import Dict, List, Optional, Sequence, Tuple

_REGISTRY: Dict[str, type] = {}


def _attr(v) -> str:
    """Escape a value destined for an HTML/SVG attribute: style strings
    (colors, backgrounds) can arrive from deserialized JSON of unknown
    provenance and must not break out of the attribute."""
    return _html.escape(str(v), quote=True)


def _register(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


def component_from_dict(d: dict) -> "Component":
    """Inverse of Component.to_dict (reference Jackson polymorphic serde)."""
    cls = _REGISTRY.get(d.get("type", ""))
    if cls is None:
        raise ValueError(f"Unknown component type '{d.get('type')}'")
    return cls._from_fields(d)


def component_from_json(s: str) -> "Component":
    return component_from_dict(json.loads(s))


@dataclasses.dataclass(frozen=True)
class Style:
    """Shared styling (reference Style/StyleChart/StyleText/StyleTable —
    collapsed into one bag; unset fields inherit page defaults)."""

    width: int = 440
    height: int = 220
    background: Optional[str] = None
    series_colors: Tuple[str, ...] = ("#2a78d6", "#eb6834", "#2e9e62",
                                      "#b04fd6", "#d6a32a", "#d64f6e")
    text_color: str = "#52514e"
    font_size: int = 11
    margin: Tuple[int, int, int, int] = (10, 12, 26, 52)  # t r b l

    def to_dict(self):
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d):
        if d is None:
            return Style()
        d = dict(d)
        d["series_colors"] = tuple(d.get("series_colors", ()))
        d["margin"] = tuple(d.get("margin", (10, 12, 26, 52)))
        return Style(**d)


class Component:
    """Base component (reference api/Component.java)."""

    def __init__(self, style: Optional[Style] = None):
        self.style = style or Style()

    # ---- serde
    def _fields(self) -> dict:
        return {}

    def to_dict(self) -> dict:
        d = {"type": type(self).__name__, "style": self.style.to_dict()}
        d.update(self._fields())
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def _from_fields(cls, d: dict) -> "Component":
        raise NotImplementedError

    # ---- render
    def render_html(self) -> str:
        raise NotImplementedError

    # ---- svg helpers
    def _svg_open(self):
        s = self.style
        bg = (f' style="background:{_attr(s.background)}"'
              if s.background else "")
        return (f'<svg viewBox="0 0 {s.width} {s.height}" width="{s.width}" '
                f'height="{s.height}"{bg} xmlns="http://www.w3.org/2000/svg">')

    def _axes(self, xmn, xmx, ymn, ymx):
        s = self.style
        t, r, b, l = s.margin
        sx = lambda v: l + (v - xmn) / ((xmx - xmn) or 1) * (s.width - l - r)
        sy = lambda v: s.height - b - (v - ymn) / ((ymx - ymn) or 1) * \
            (s.height - t - b)
        parts = []
        for i in range(4):
            yv = ymn + (ymx - ymn) * i / 3
            parts.append(f'<line x1="{l}" y1="{sy(yv):.1f}" '
                         f'x2="{s.width - r}" y2="{sy(yv):.1f}" '
                         f'stroke="#e3e2de" stroke-width="1"/>')
            parts.append(f'<text x="{l - 6}" y="{sy(yv) + 3:.1f}" '
                         f'text-anchor="end" fill="{_attr(s.text_color)}" '
                         f'font-size="{s.font_size}">{yv:.3g}</text>')
        for i in range(5):
            xv = xmn + (xmx - xmn) * i / 4
            parts.append(f'<text x="{sx(xv):.1f}" y="{s.height - 8}" '
                         f'text-anchor="middle" fill="{_attr(s.text_color)}" '
                         f'font-size="{s.font_size}">{xv:.3g}</text>')
        return sx, sy, "".join(parts)


class _TitledChart(Component):
    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(style)
        self.title = title

    def _title_svg(self):
        if not self.title:
            return ""
        return (f'<text x="{self.style.margin[3]}" y="12" font-weight="600" '
                f'fill="#0b0b0b" font-size="12">'
                f'{_html.escape(self.title)}</text>')


@_register
class ChartLine(_TitledChart):
    """Multi-series line chart (reference chart/ChartLine.java)."""

    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(title, style)
        self.series: List[Tuple[str, List[float], List[float]]] = []

    def add_series(self, name: str, x: Sequence[float], y: Sequence[float]):
        if len(x) != len(y):
            raise ValueError("x and y must align")
        self.series.append((str(name), [float(v) for v in x],
                            [float(v) for v in y]))
        return self

    def _fields(self):
        return {"title": self.title,
                "series": [{"name": n, "x": x, "y": y}
                           for n, x, y in self.series]}

    @classmethod
    def _from_fields(cls, d):
        c = cls(d.get("title", ""), Style.from_dict(d.get("style")))
        for s in d.get("series", []):
            c.add_series(s["name"], s["x"], s["y"])
        return c

    def render_html(self) -> str:
        allx = [v for _, x, _ in self.series for v in x] or [0, 1]
        ally = [v for _, _, y in self.series for v in y] or [0, 1]
        sx, sy, axes = self._axes(min(allx), max(allx), min(ally), max(ally))
        out = [self._svg_open(), axes, self._title_svg()]
        for i, (name, x, y) in enumerate(self.series):
            col = _attr(self.style.series_colors[i % len(self.style.series_colors)])
            pts = " ".join(f"{sx(a):.1f},{sy(b):.1f}" for a, b in zip(x, y))
            out.append(f'<polyline points="{pts}" fill="none" '
                       f'stroke="{col}" stroke-width="2">'
                       f'<title>{_html.escape(name)}</title></polyline>')
        out.append("</svg>")
        return "".join(out)


@_register
class ChartScatter(ChartLine):
    """Scatter chart (reference chart/ChartScatter.java)."""

    def render_html(self) -> str:
        allx = [v for _, x, _ in self.series for v in x] or [0, 1]
        ally = [v for _, _, y in self.series for v in y] or [0, 1]
        sx, sy, axes = self._axes(min(allx), max(allx), min(ally), max(ally))
        out = [self._svg_open(), axes, self._title_svg()]
        for i, (name, x, y) in enumerate(self.series):
            col = _attr(self.style.series_colors[i % len(self.style.series_colors)])
            for a, b in zip(x, y):
                out.append(f'<circle cx="{sx(a):.1f}" cy="{sy(b):.1f}" '
                           f'r="2.5" fill="{col}" opacity="0.75"/>')
        out.append("</svg>")
        return "".join(out)


@_register
class ChartHistogram(_TitledChart):
    """Histogram of (low, high, count) bins (reference ChartHistogram.java)."""

    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(title, style)
        self.bins: List[Tuple[float, float, float]] = []

    def add_bin(self, low: float, high: float, count: float):
        self.bins.append((float(low), float(high), float(count)))
        return self

    def _fields(self):
        return {"title": self.title,
                "bins": [list(b) for b in self.bins]}

    @classmethod
    def _from_fields(cls, d):
        c = cls(d.get("title", ""), Style.from_dict(d.get("style")))
        for lo, hi, n in d.get("bins", []):
            c.add_bin(lo, hi, n)
        return c

    def render_html(self) -> str:
        if not self.bins:
            return self._svg_open() + "</svg>"
        xmn = min(b[0] for b in self.bins)
        xmx = max(b[1] for b in self.bins)
        ymx = max(b[2] for b in self.bins) or 1
        sx, sy, axes = self._axes(xmn, xmx, 0, ymx)
        out = [self._svg_open(), axes, self._title_svg()]
        col = _attr(self.style.series_colors[0])
        for lo, hi, n in self.bins:
            x0, x1 = sx(lo), sx(hi)
            y = sy(n)
            base = sy(0)
            out.append(f'<rect x="{x0 + 1:.1f}" y="{y:.1f}" '
                       f'width="{max(x1 - x0 - 2, 1):.1f}" '
                       f'height="{max(base - y, 0):.1f}" fill="{col}" '
                       f'rx="2"><title>[{lo:.3g}, {hi:.3g}): {n:.0f}'
                       f'</title></rect>')
        out.append("</svg>")
        return "".join(out)


@_register
class ChartHorizontalBar(_TitledChart):
    """Named horizontal bars (reference ChartHorizontalBar.java)."""

    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(title, style)
        self.values: List[Tuple[str, float]] = []

    def add_value(self, name: str, value: float):
        self.values.append((str(name), float(value)))
        return self

    def _fields(self):
        return {"title": self.title,
                "values": [[n, v] for n, v in self.values]}

    @classmethod
    def _from_fields(cls, d):
        c = cls(d.get("title", ""), Style.from_dict(d.get("style")))
        for n, v in d.get("values", []):
            c.add_value(n, v)
        return c

    def render_html(self) -> str:
        s = self.style
        if not self.values:
            return self._svg_open() + "</svg>"
        t, r, b, l = s.margin
        vmax = max(v for _, v in self.values) or 1
        bh = (s.height - t - b) / len(self.values)
        col = _attr(s.series_colors[0])
        out = [self._svg_open(), self._title_svg()]
        for i, (name, v) in enumerate(self.values):
            y = t + i * bh
            w = (v / vmax) * (s.width - l - r)
            out.append(f'<rect x="{l}" y="{y + 2:.1f}" width="{w:.1f}" '
                       f'height="{max(bh - 4, 2):.1f}" fill="{col}" rx="2"/>')
            out.append(f'<text x="{l - 6}" y="{y + bh / 2 + 3:.1f}" '
                       f'text-anchor="end" fill="{_attr(s.text_color)}" '
                       f'font-size="{s.font_size}">'
                       f'{_html.escape(name)}</text>')
            out.append(f'<text x="{l + w + 4:.1f}" y="{y + bh / 2 + 3:.1f}" '
                       f'fill="{_attr(s.text_color)}" font-size="{s.font_size}">'
                       f'{v:.3g}</text>')
        out.append("</svg>")
        return "".join(out)


@_register
class ChartStackedArea(_TitledChart):
    """Stacked area over shared x (reference ChartStackedArea.java)."""

    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(title, style)
        self.x: List[float] = []
        self.series: List[Tuple[str, List[float]]] = []

    def set_x(self, x: Sequence[float]):
        self.x = [float(v) for v in x]
        return self

    def add_series(self, name: str, y: Sequence[float]):
        if len(y) != len(self.x):
            raise ValueError("series must align with x (call set_x first)")
        self.series.append((str(name), [float(v) for v in y]))
        return self

    def _fields(self):
        return {"title": self.title, "x": self.x,
                "series": [{"name": n, "y": y} for n, y in self.series]}

    @classmethod
    def _from_fields(cls, d):
        c = cls(d.get("title", ""), Style.from_dict(d.get("style")))
        c.set_x(d.get("x", []))
        for sdef in d.get("series", []):
            c.add_series(sdef["name"], sdef["y"])
        return c

    def render_html(self) -> str:
        if not self.x or not self.series:
            return self._svg_open() + "</svg>"
        stacked = []
        acc = [0.0] * len(self.x)
        for name, y in self.series:
            acc = [a + v for a, v in zip(acc, y)]
            stacked.append(list(acc))
        sx, sy, axes = self._axes(min(self.x), max(self.x), 0, max(acc) or 1)
        out = [self._svg_open(), axes, self._title_svg()]
        prev = [0.0] * len(self.x)
        for i, ((name, _), top) in enumerate(zip(self.series, stacked)):
            col = _attr(self.style.series_colors[i % len(self.style.series_colors)])
            fwd = " ".join(f"{sx(a):.1f},{sy(b):.1f}"
                           for a, b in zip(self.x, top))
            back = " ".join(f"{sx(a):.1f},{sy(b):.1f}"
                            for a, b in zip(reversed(self.x), reversed(prev)))
            out.append(f'<polygon points="{fwd} {back}" fill="{col}" '
                       f'opacity="0.8"><title>{_html.escape(name)}</title>'
                       f'</polygon>')
            prev = top
        out.append("</svg>")
        return "".join(out)


@_register
class ChartTimeline(_TitledChart):
    """Lanes of [start, end, label] entries (reference ChartTimeline.java)."""

    def __init__(self, title: str = "", style: Optional[Style] = None):
        super().__init__(title, style)
        self.lanes: List[Tuple[str, List[Tuple[float, float, str]]]] = []

    def add_lane(self, name: str, entries):
        self.lanes.append((str(name),
                           [(float(a), float(b), str(lbl))
                            for a, b, lbl in entries]))
        return self

    def _fields(self):
        return {"title": self.title,
                "lanes": [{"name": n, "entries": [list(e) for e in es]}
                          for n, es in self.lanes]}

    @classmethod
    def _from_fields(cls, d):
        c = cls(d.get("title", ""), Style.from_dict(d.get("style")))
        for lane in d.get("lanes", []):
            c.add_lane(lane["name"], lane["entries"])
        return c

    def render_html(self) -> str:
        s = self.style
        if not self.lanes:
            return self._svg_open() + "</svg>"
        t, r, b, l = s.margin
        tmn = min(e[0] for _, es in self.lanes for e in es)
        tmx = max(e[1] for _, es in self.lanes for e in es) or (tmn + 1)
        lh = (s.height - t - b) / len(self.lanes)
        sx = lambda v: l + (v - tmn) / ((tmx - tmn) or 1) * (s.width - l - r)
        out = [self._svg_open(), self._title_svg()]
        for i, (name, entries) in enumerate(self.lanes):
            y = t + i * lh
            col = _attr(s.series_colors[i % len(s.series_colors)])
            out.append(f'<text x="{l - 6}" y="{y + lh / 2 + 3:.1f}" '
                       f'text-anchor="end" fill="{_attr(s.text_color)}" '
                       f'font-size="{s.font_size}">'
                       f'{_html.escape(name)}</text>')
            for a, bb, lbl in entries:
                out.append(f'<rect x="{sx(a):.1f}" y="{y + 2:.1f}" '
                           f'width="{max(sx(bb) - sx(a), 1):.1f}" '
                           f'height="{max(lh - 4, 2):.1f}" fill="{col}" '
                           f'rx="2"><title>{_html.escape(lbl)}</title></rect>')
        out.append("</svg>")
        return "".join(out)


@_register
class ComponentText(Component):
    """(reference text/ComponentText.java)"""

    def __init__(self, text: str = "", style: Optional[Style] = None):
        super().__init__(style)
        self.text = text

    def _fields(self):
        return {"text": self.text}

    @classmethod
    def _from_fields(cls, d):
        return cls(d.get("text", ""), Style.from_dict(d.get("style")))

    def render_html(self) -> str:
        return (f'<p style="color:{_attr(self.style.text_color)};font-size:'
                f'{self.style.font_size + 2}px">'
                f'{_html.escape(self.text)}</p>')


@_register
class ComponentTable(Component):
    """(reference table/ComponentTable.java)"""

    def __init__(self, header: Sequence[str] = (), style: Optional[Style] = None):
        super().__init__(style)
        self.header = [str(h) for h in header]
        self.rows: List[List[str]] = []

    def add_row(self, *cells):
        self.rows.append([str(c) for c in cells])
        return self

    def _fields(self):
        return {"header": self.header, "rows": self.rows}

    @classmethod
    def _from_fields(cls, d):
        c = cls(d.get("header", ()), Style.from_dict(d.get("style")))
        for row in d.get("rows", []):
            c.add_row(*row)
        return c

    def render_html(self) -> str:
        th = "".join(f'<th style="text-align:left;padding:3px 12px 3px 0">'
                     f'{_html.escape(h)}</th>' for h in self.header)
        trs = "".join(
            "<tr>" + "".join(f'<td style="padding:3px 12px 3px 0">'
                             f'{_html.escape(c)}</td>' for c in row) + "</tr>"
            for row in self.rows)
        return (f'<table style="border-collapse:collapse;font-size:13px">'
                f'<thead><tr>{th}</tr></thead><tbody>{trs}</tbody></table>')


@_register
class ComponentDiv(Component):
    """Container (reference ComponentDiv.java)."""

    def __init__(self, *children: Component, style: Optional[Style] = None):
        super().__init__(style)
        self.children = list(children)

    def add(self, child: Component):
        self.children.append(child)
        return self

    def _fields(self):
        return {"children": [c.to_dict() for c in self.children]}

    @classmethod
    def _from_fields(cls, d):
        c = cls(style=Style.from_dict(d.get("style")))
        for ch in d.get("children", []):
            c.add(component_from_dict(ch))
        return c

    def render_html(self) -> str:
        inner = "".join(c.render_html() for c in self.children)
        return f'<div style="display:flex;gap:16px;flex-wrap:wrap">{inner}</div>'


@_register
class DecoratorAccordion(Component):
    """Collapsible section (reference decorator/DecoratorAccordion.java) —
    pure HTML <details>, no JS."""

    def __init__(self, title: str = "", *children: Component,
                 default_collapsed: bool = True,
                 style: Optional[Style] = None):
        super().__init__(style)
        self.title = title
        self.children = list(children)
        self.default_collapsed = default_collapsed

    def add(self, child: Component):
        self.children.append(child)
        return self

    def _fields(self):
        return {"title": self.title,
                "default_collapsed": self.default_collapsed,
                "children": [c.to_dict() for c in self.children]}

    @classmethod
    def _from_fields(cls, d):
        c = cls(d.get("title", ""),
                default_collapsed=d.get("default_collapsed", True),
                style=Style.from_dict(d.get("style")))
        for ch in d.get("children", []):
            c.add(component_from_dict(ch))
        return c

    def render_html(self) -> str:
        op = "" if self.default_collapsed else " open"
        inner = "".join(c.render_html() for c in self.children)
        return (f'<details{op}><summary style="cursor:pointer;font-weight:600">'
                f'{_html.escape(self.title)}</summary>{inner}</details>')


def render_page(components: Sequence[Component], title: str = "report") -> str:
    """Full standalone HTML page (no external assets — zero-egress hosts)."""
    body = "".join(c.render_html() for c in components)
    return (f'<!DOCTYPE html><html><head><meta charset="utf-8">'
            f'<title>{_html.escape(title)}</title></head>'
            f'<body style="font:14px/1.45 system-ui,sans-serif;'
            f'background:#fcfcfb;color:#0b0b0b;padding:20px 28px">'
            f'{body}</body></html>')
