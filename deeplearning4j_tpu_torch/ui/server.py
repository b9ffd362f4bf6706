"""Training UI server: dashboards over a StatsStorage (counterpart of
``deeplearning4j_tpu/ui/server.py``: the same routes, answers and pages; the
dashboard's software line reads the port's static record, ``torch`` and
``cuda`` where the JAX one reads ``jax`` and ``backend``).

Parity surface: reference
``deeplearning4j-ui-parent/deeplearning4j-play/.../PlayUIServer.java:51``
(UIServer.getInstance().attach(statsStorage) lifecycle),
``module/train/TrainModule.java`` (overview / model routes).

Design: the Play/Netty server + SBE decoding + separate JS bundles
become a stdlib ``ThreadingHTTPServer`` serving one self-contained HTML page
(inline CSS/JS/SVG, no external assets — the training hosts have no egress)
plus JSON endpoints reading straight from the JSON-record storage.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from deeplearning4j_tpu_torch.ui.stats import TYPE_ID

log = logging.getLogger(__name__)

_DASHBOARD_HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>deeplearning4j-tpu training UI</title>
<style>
.viz-root {
  color-scheme: light;
  --surface-1: #fcfcfb; --surface-2: #f0efec;
  --text-primary: #0b0b0b; --text-secondary: #52514e;
  --series-1: #2a78d6; --series-2: #eb6834; --grid: #e3e2de;
}
@media (prefers-color-scheme: dark) {
  :root:where(:not([data-theme="light"])) .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19; --surface-2: #383835;
    --text-primary: #ffffff; --text-secondary: #c3c2b7;
    --series-1: #3987e5; --series-2: #d95926; --grid: #32312f;
  }
}
body { margin: 0; font: 14px/1.45 system-ui, sans-serif; }
.viz-root { background: var(--surface-1); color: var(--text-primary);
  min-height: 100vh; padding: 20px 28px; box-sizing: border-box; }
h1 { font-size: 18px; font-weight: 600; margin: 0 0 4px; }
h2 { font-size: 13px; font-weight: 600; margin: 0 0 8px;
  color: var(--text-secondary); text-transform: uppercase;
  letter-spacing: .04em; }
.sub { color: var(--text-secondary); margin-bottom: 16px; }
.controls { display: flex; gap: 12px; align-items: center;
  margin-bottom: 18px; flex-wrap: wrap; }
select { background: var(--surface-1); color: var(--text-primary);
  border: 1px solid var(--grid); border-radius: 6px; padding: 4px 8px; }
.tiles { display: flex; gap: 14px; flex-wrap: wrap; margin-bottom: 18px; }
.tile { background: var(--surface-2); border-radius: 10px;
  padding: 12px 18px; min-width: 130px; }
.tile .v { font-size: 22px; font-weight: 650; font-variant-numeric: tabular-nums; }
.tile .l { font-size: 12px; color: var(--text-secondary); }
.grid2 { display: grid; grid-template-columns: repeat(auto-fit, minmax(420px, 1fr));
  gap: 18px; }
.card { background: var(--surface-1); border: 1px solid var(--grid);
  border-radius: 10px; padding: 14px; }
svg text { fill: var(--text-secondary); font: 11px system-ui, sans-serif; }
svg .axis { stroke: var(--grid); stroke-width: 1; }
svg .line1 { stroke: var(--series-1); stroke-width: 2; fill: none; }
svg .line2 { stroke: var(--series-2); stroke-width: 2; fill: none; }
svg .bar { fill: var(--series-1); }
.tooltip { position: fixed; pointer-events: none; background: var(--surface-2);
  color: var(--text-primary); border: 1px solid var(--grid); border-radius: 6px;
  padding: 6px 9px; font-size: 12px; display: none; z-index: 10; }
table.info { border-collapse: collapse; font-size: 13px; }
table.info td { padding: 3px 14px 3px 0; vertical-align: top; }
table.info td:first-child { color: var(--text-secondary); }
</style></head>
<body><div class="viz-root">
<h1>deeplearning4j-tpu training UI</h1>
<div class="sub" id="subtitle">loading…</div>
<div class="controls">
  <label>Session <select id="session"></select></label>
  <label>Parameter <select id="param"></select></label>
</div>
<div class="tiles" id="tiles"></div>
<div class="grid2">
  <div class="card"><h2>Score vs iteration</h2><div id="score"></div></div>
  <div class="card"><h2>Update : parameter ratio (log10, mean magnitude)</h2><div id="ratio"></div></div>
  <div class="card"><h2>Parameter histogram (latest)</h2><div id="phist"></div></div>
  <div class="card"><h2>Update histogram (latest)</h2><div id="uhist"></div></div>
  <div class="card"><h2>Parameter mean &amp; stdev</h2><div id="pstats"></div></div>
  <div class="card"><h2>Throughput (examples/sec)</h2><div id="perf"></div></div>
  <div class="card"><h2>Memory</h2><div id="mem"></div></div>
  <div class="card"><h2>Model / system</h2><div id="static"></div></div>
</div>
<div class="tooltip" id="tt"></div>
</div>
<script>
"use strict";
const W = 430, H = 190, PAD = {l: 52, r: 12, t: 10, b: 26};
const $ = id => document.getElementById(id);
function fmt(v) {
  if (!isFinite(v)) return "—";
  const a = Math.abs(v);
  if (a >= 1e9) return (v/1e9).toFixed(2) + "G";
  if (a >= 1e6) return (v/1e6).toFixed(2) + "M";
  if (a >= 1e3) return (v/1e3).toFixed(1) + "k";
  if (a >= 1 || a === 0) return v.toFixed(3).replace(/\.?0+$/, "");
  return v.toExponential(2);
}
function scale(vals, lo, hi) {
  let mn = Math.min(...vals), mx = Math.max(...vals);
  if (!isFinite(mn) || !isFinite(mx)) { mn = 0; mx = 1; }
  if (mn === mx) { mn -= 1; mx += 1; }
  return v => lo + (v - mn) / (mx - mn) * (hi - lo);
}
function ticks(vals, n) {
  let mn = Math.min(...vals), mx = Math.max(...vals);
  if (!isFinite(mn) || !isFinite(mx) || mn === mx) return [mn];
  const out = [];
  for (let i = 0; i <= n; i++) out.push(mn + (mx - mn) * i / n);
  return out;
}
// single-series line chart with crosshair tooltip; ys2 optional second series
function lineChart(el, xs, ys, opts) {
  opts = opts || {};
  if (!xs.length) { el.innerHTML = "<div class='sub'>no data yet</div>"; return; }
  const sx = scale(xs, PAD.l, W - PAD.r), sy = scale(ys, H - PAD.b, PAD.t);
  let svg = `<svg viewBox="0 0 ${W} ${H}" width="100%">`;
  for (const t of ticks(ys, 3)) {
    const y = sy(t);
    svg += `<line class="axis" x1="${PAD.l}" y1="${y}" x2="${W-PAD.r}" y2="${y}"/>`;
    svg += `<text x="${PAD.l-6}" y="${y+3}" text-anchor="end">${fmt(t)}</text>`;
  }
  for (const t of ticks(xs, 4)) {
    svg += `<text x="${sx(t)}" y="${H-8}" text-anchor="middle">${fmt(t)}</text>`;
  }
  const pts = xs.map((x, i) => `${sx(x).toFixed(1)},${sy(ys[i]).toFixed(1)}`);
  svg += `<polyline class="line1" points="${pts.join(" ")}"/>`;
  svg += `<line id="ch" stroke="var(--text-secondary)" stroke-dasharray="3,3" y1="${PAD.t}" y2="${H-PAD.b}" style="display:none"/>`;
  svg += `</svg>`;
  el.innerHTML = svg;
  const node = el.querySelector("svg"), ch = el.querySelector("#ch"), tt = $("tt");
  node.addEventListener("mousemove", ev => {
    const r = node.getBoundingClientRect();
    const px = (ev.clientX - r.left) / r.width * W;
    let best = 0, bd = 1e18;
    xs.forEach((x, i) => { const d = Math.abs(sx(x) - px); if (d < bd) { bd = d; best = i; } });
    ch.setAttribute("x1", sx(xs[best])); ch.setAttribute("x2", sx(xs[best]));
    ch.style.display = "";
    tt.style.display = "block";
    tt.style.left = (ev.clientX + 14) + "px"; tt.style.top = (ev.clientY + 10) + "px";
    tt.textContent = `${opts.xlabel || "iter"} ${fmt(xs[best])} — ${fmt(ys[best])}${opts.unit || ""}`;
  });
  node.addEventListener("mouseleave", () => { ch.style.display = "none"; tt.style.display = "none"; });
}
// histogram bars: 4px-rounded data ends anchored to baseline, 2px surface gaps
function histChart(el, hist) {
  if (!hist || !hist.counts || !hist.counts.length) {
    el.innerHTML = "<div class='sub'>no data yet</div>"; return;
  }
  const n = hist.counts.length, mx = Math.max(...hist.counts, 1);
  const x0 = PAD.l, x1 = W - PAD.r, bw = (x1 - x0) / n;
  let svg = `<svg viewBox="0 0 ${W} ${H}" width="100%">`;
  svg += `<line class="axis" x1="${x0}" y1="${H-PAD.b}" x2="${x1}" y2="${H-PAD.b}"/>`;
  hist.counts.forEach((c, i) => {
    const h = c / mx * (H - PAD.t - PAD.b);
    const y = H - PAD.b - h;
    svg += `<path class="bar" d="M${(x0+i*bw+1).toFixed(1)} ${H-PAD.b} v${-Math.max(h-4,0)} q0,-4 4,-4 h${(bw-10).toFixed(1)} q4,0 4,4 v${Math.max(h-4,0)} z" data-i="${i}"><title>${fmt(hist.min + (hist.max-hist.min)*(i+0.5)/n)}: ${c}</title></path>`;
  });
  svg += `<text x="${x0}" y="${H-8}">${fmt(hist.min)}</text>`;
  svg += `<text x="${x1}" y="${H-8}" text-anchor="end">${fmt(hist.max)}</text>`;
  svg += `</svg>`;
  el.innerHTML = svg;
}
async function j(url) { const r = await fetch(url); return r.json(); }
let CUR = null;
async function loadSessions() {
  const sessions = await j("/api/sessions");
  const sel = $("session");
  sel.innerHTML = sessions.map(s => `<option>${s}</option>`).join("");
  if (sessions.length) { CUR = sessions[sessions.length-1]; sel.value = CUR; await render(); }
  else $("subtitle").textContent = "no sessions in storage";
  sel.onchange = async () => { CUR = sel.value; await render(true); };
  $("param").onchange = () => render();
}
function tile(label, value) {
  return `<div class="tile"><div class="v">${value}</div><div class="l">${label}</div></div>`;
}
async function render(resetParam) {
  const [stat, updates, obs] = await Promise.all([
    j(`/api/static?session=${encodeURIComponent(CUR)}`),
    j(`/api/updates?session=${encodeURIComponent(CUR)}`),
    j("/api/obs").catch(() => ({}))]);
  const last = updates[updates.length-1] || {};
  $("subtitle").textContent = stat && stat.model ?
    `${stat.model.class} — ${fmt(stat.model.num_params)} params — ${stat.hardware.device_kind} ×${stat.hardware.device_count}` : CUR;
  const pnames = last.parameters ? Object.keys(last.parameters) : [];
  const psel = $("param");
  if (resetParam !== false || psel.options.length !== pnames.length) {
    const prev = psel.value;
    psel.innerHTML = pnames.map(p => `<option>${p}</option>`).join("");
    if (pnames.includes(prev)) psel.value = prev;
  }
  const P = psel.value || pnames[0];
  const iters = updates.map(u => u.iteration);
  const perf = last.performance || {};
  // obs tiles: registry-backed telemetry (hot-swap + elastic fleet state)
  // rendered only when the process actually reports it
  const obsVal = n => obs && obs[n] ? obs[n].value : undefined;
  let obsTiles = "";
  if (obsVal("serving_hot_swap_swaps") !== undefined)
    obsTiles += tile("hot swaps", fmt(obsVal("serving_hot_swap_swaps")));
  if (obsVal("serving_hot_swap_poll_errors") !== undefined)
    obsTiles += tile("swap poll errors", fmt(obsVal("serving_hot_swap_poll_errors")));
  if (obsVal("elastic_generation") !== undefined)
    obsTiles += tile("elastic generation", fmt(obsVal("elastic_generation")));
  $("tiles").innerHTML =
    tile("last score", fmt(last.score)) +
    tile("iteration", fmt(last.iteration ?? 0)) +
    tile("examples/sec", fmt(perf.examples_per_second || 0)) +
    tile("total examples", fmt(perf.total_examples || 0)) +
    tile("runtime", fmt((perf.total_runtime_ms || 0)/1000) + "s") +
    obsTiles;
  lineChart($("score"), iters, updates.map(u => u.score ?? NaN));
  lineChart($("ratio"), iters,
    updates.map(u => u.update_ratios && u.update_ratios[P] > 0 ? Math.log10(u.update_ratios[P]) : NaN));
  histChart($("phist"), last.parameters && last.parameters[P] && last.parameters[P].histogram);
  histChart($("uhist"), last.updates && last.updates[P] && last.updates[P].histogram);
  lineChart($("pstats"), iters,
    updates.map(u => u.parameters && u.parameters[P] ? u.parameters[P].mean : NaN));
  lineChart($("perf"), iters,
    updates.map(u => (u.performance || {}).examples_per_second ?? NaN), {unit: " ex/s"});
  lineChart($("mem"), iters,
    updates.map(u => (u.memory || {}).host_rss_bytes ?? NaN), {unit: " B"});
  if (stat) {
    const sw = stat.software || {}, hw = stat.hardware || {};
    $("static").innerHTML = `<table class="info">
      <tr><td>software</td><td>torch ${sw.torch} (cuda ${sw.cuda}, python ${sw.python})</td></tr>
      <tr><td>device</td><td>${hw.device_kind} ×${hw.device_count}</td></tr>
      <tr><td>host</td><td>${sw.hostname}</td></tr>
      <tr><td>worker</td><td>${stat.worker_id}</td></tr>
      <tr><td>params</td><td>${stat.model ? Object.entries(stat.model.param_shapes).map(
        ([k, s]) => `${k} [${s}]`).join("<br>") : ""}</td></tr></table>`;
  }
}
loadSessions();
setInterval(() => { if (CUR) render(false); }, 3000);
</script></body></html>
"""


_TSNE_HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>t-SNE viewer</title>
<style>
body { margin: 0; font: 14px/1.45 system-ui, sans-serif; background: #fcfcfb;
  color: #0b0b0b; }
.wrap { padding: 20px 28px; }
h1 { font-size: 18px; font-weight: 600; margin: 0 0 10px; }
select { border: 1px solid #e3e2de; border-radius: 6px; padding: 4px 8px; }
svg { background: #fff; border: 1px solid #e3e2de; border-radius: 10px; }
circle { opacity: .75; }
.lbl { font-size: 9px; fill: #52514e; }
</style></head>
<body><div class="wrap">
<h1>t-SNE viewer</h1>
<label>Session <select id="session"></select></label>
<div id="plot" style="margin-top:14px"></div>
<script>
"use strict";
const $ = id => document.getElementById(id);
const PALETTE = ["#2a78d6","#eb6834","#2e9e62","#b04fd6","#d6a32a",
                 "#d64f6e","#3ec6c0","#8a6d4f","#6277d8","#9aa53b"];
// session names and labels arrive from unauthenticated POSTs: escape before
// any innerHTML interpolation (stored-XSS guard)
const esc = s => String(s).replaceAll("&", "&amp;").replaceAll("<", "&lt;")
  .replaceAll(">", "&gt;").replaceAll('"', "&quot;").replaceAll("'", "&#39;");
async function j(url) { const r = await fetch(url); return r.json(); }
async function load() {
  const sessions = await j("/api/tsne/sessions");
  const sel = $("session");
  sel.innerHTML = sessions.map(s => `<option>${esc(s)}</option>`).join("");
  sel.onchange = () => render(sel.value);
  if (sessions.length) render(sessions[sessions.length-1]);
  else $("plot").textContent = "no t-SNE sessions uploaded";
}
async function render(name) {
  const d = await j(`/api/tsne/data?session=${encodeURIComponent(name)}`);
  const xs = d.coords.map(c => c[0]), ys = d.coords.map(c => c[1]);
  const mnx = Math.min(...xs), mxx = Math.max(...xs);
  const mny = Math.min(...ys), mxy = Math.max(...ys);
  const S = 640, P = 24;
  const sx = v => P + (v - mnx) / (mxx - mnx || 1) * (S - 2*P);
  const sy = v => S - P - (v - mny) / (mxy - mny || 1) * (S - 2*P);
  const cats = [...new Set(d.labels || [])];
  let svg = `<svg viewBox="0 0 ${S} ${S}" width="${S}" height="${S}">`;
  d.coords.forEach((c, i) => {
    const col = d.labels ? PALETTE[cats.indexOf(d.labels[i]) % PALETTE.length]
                         : PALETTE[0];
    svg += `<circle cx="${sx(c[0]).toFixed(1)}" cy="${sy(c[1]).toFixed(1)}" r="2.5" fill="${col}"><title>${d.labels ? esc(d.labels[i]) : i}</title></circle>`;
  });
  cats.forEach((c, k) => {
    svg += `<circle cx="${S-86}" cy="${18+k*14}" r="4" fill="${PALETTE[k % PALETTE.length]}"/>`;
    svg += `<text class="lbl" x="${S-76}" y="${21+k*14}">${esc(c)}</text>`;
  });
  svg += `</svg>`;
  $("plot").innerHTML = svg;
}
load();
</script></div></body></html>
"""

_ACTIVATIONS_HTML = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>Convolutional activations</title>
<style>
body { margin: 0; font: 14px/1.45 system-ui, sans-serif; background: #fcfcfb;
  color: #0b0b0b; }
.wrap { padding: 20px 28px; }
h1 { font-size: 18px; font-weight: 600; margin: 0 0 10px; }
h2 { font-size: 13px; color: #52514e; margin: 16px 0 6px; }
img { image-rendering: pixelated; border: 1px solid #e3e2de;
  border-radius: 6px; max-width: 480px; }
select { border: 1px solid #e3e2de; border-radius: 6px; padding: 4px 8px; }
.meta { color: #52514e; font-size: 12px; }
</style></head>
<body><div class="wrap">
<h1>Convolutional activations</h1>
<label>Session <select id="session"></select></label>
<span class="meta" id="meta"></span>
<div id="grids"></div>
<script>
"use strict";
const $ = id => document.getElementById(id);
const esc = s => String(s).replaceAll("&", "&amp;").replaceAll("<", "&lt;")
  .replaceAll(">", "&gt;").replaceAll('"', "&quot;").replaceAll("'", "&#39;");
async function j(url) { const r = await fetch(url); return r.json(); }
async function load() {
  const sessions = await j("/api/activations/sessions");
  const sel = $("session");
  sel.innerHTML = sessions.map(s => `<option>${esc(s)}</option>`).join("");
  sel.onchange = () => render(sel.value);
  if (sessions.length) render(sessions[sessions.length-1]);
  else $("grids").textContent = "no activation records";
}
async function render(name) {
  const recs = await j(`/api/activations/data?session=${encodeURIComponent(name)}`);
  const last = recs[recs.length-1];
  if (!last) { $("grids").textContent = "no activation records"; return; }
  $("meta").textContent = `iteration ${last.iteration}`;
  $("grids").innerHTML = Object.entries(last.layers).map(([layer, png]) =>
    `<h2>${esc(layer)}</h2><img src="data:image/png;base64,${esc(png)}" alt="${esc(layer)}"/>`
  ).join("");
}
load();
setInterval(() => { const s = $("session").value; if (s) render(s); }, 4000);
</script></div></body></html>
"""

# type id for convolutional-activation update records (reference
# ConvolutionalListenerModule.java:32 consumes ConvolutionIterationListener)
ACTIVATIONS_TYPE_ID = "ActivationsListener"


def _sanitize_tsne(coords, labels=None) -> dict:
    """Coerce to a rectangular float (n, 2) list + stringified labels; the
    viewer reads c[0]/c[1] of every row, so ragged/non-numeric input must be
    rejected at upload time, whichever path it arrives by."""
    import numpy as np
    c = np.asarray(coords, float)
    if c.ndim != 2 or c.shape[1] < 2:
        raise ValueError("coords must be (n, >=2)")
    if not np.isfinite(c[:, :2]).all():
        # bare NaN/Infinity tokens are invalid JSON: the viewer's
        # response.json() would throw and silently never render
        raise ValueError("coords must be finite")
    out_labels = None
    if labels is not None:
        if len(labels) != c.shape[0]:
            raise ValueError("labels must align with coords")
        out_labels = [str(l) for l in labels]
    return {"coords": c[:, :2].tolist(), "labels": out_labels}


class _Handler(BaseHTTPRequestHandler):
    storage = None  # set by UIServer
    tsne_sessions = None  # dict name -> {"coords": [[x,y]...], "labels": [...]}

    def log_message(self, fmt, *args):  # quiet
        pass

    def _send(self, code, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, obj):
        self._send(200, json.dumps(obj).encode(), "application/json")

    def do_GET(self):
        url = urlparse(self.path)
        q = parse_qs(url.query)
        session = q.get("session", [None])[0]
        st = type(self).storage
        if st is not None and url.path.startswith("/api/"):
            # live-tail: pick up records another process appended to the file
            getattr(st, "refresh", lambda: 0)()
        if url.path in ("/", "/train", "/train/overview"):
            self._send(200, _DASHBOARD_HTML.encode(), "text/html; charset=utf-8")
        elif url.path == "/tsne":
            # reference TsneModule.java:26 /tsne route
            self._send(200, _TSNE_HTML.encode(), "text/html; charset=utf-8")
        elif url.path == "/activations":
            # reference ConvolutionalListenerModule.java:32 /activations
            self._send(200, _ACTIVATIONS_HTML.encode(),
                       "text/html; charset=utf-8")
        elif url.path == "/metrics":
            # Prometheus exposition of the process-wide MetricsRegistry
            # (obs/): scrape target for the fleet — the registry absorbs
            # CompileWatch, serving stats, checkpoint + elastic telemetry
            from deeplearning4j_tpu_torch.obs.exporters import prometheus_text
            self._send(200, prometheus_text().encode(),
                       "text/plain; version=0.0.4; charset=utf-8")
        elif url.path == "/api/obs":
            # the same registry as JSON — what the dashboard's obs tiles
            # (hot-swap swaps / poll errors, elastic generation) read
            from deeplearning4j_tpu_torch.obs.registry import get_registry
            self._json(get_registry().as_dict())
        elif url.path == "/api/sessions":
            self._json(st.list_session_ids() if st else [])
        elif url.path == "/api/static":
            self._json(st.get_static_info(session, TYPE_ID) if st else None)
        elif url.path == "/api/updates":
            self._json(st.get_all_updates(session, TYPE_ID) if st else [])
        elif url.path == "/api/tsne/sessions":
            ts = type(self).tsne_sessions or {}
            self._json(sorted(ts.keys()))
        elif url.path == "/api/tsne/data":
            ts = type(self).tsne_sessions or {}
            if session in ts:
                self._json(ts[session])
            else:
                self._send(404, b"unknown t-SNE session", "text/plain")
        elif url.path == "/api/activations/sessions":
            if st is None:
                self._json([])
            else:
                self._json([s for s in st.list_session_ids()
                            if ACTIVATIONS_TYPE_ID in st.list_type_ids(s)])
        elif url.path == "/api/activations/data":
            self._json(st.get_all_updates(session, ACTIVATIONS_TYPE_ID)
                       if st else [])
        elif url.path == "/api/i18n":
            # reference I18N route: language-keyed UI labels
            from deeplearning4j_tpu_torch.ui.i18n import DefaultI18N
            lang = q.get("lang", [None])[0]
            i18n = DefaultI18N.get_instance()
            if lang is not None and lang not in i18n.languages():
                self._send(400, f"Unknown language '{lang}' "
                           f"(have {i18n.languages()})".encode(), "text/plain")
            else:
                self._json({"language": lang or i18n.get_default_language(),
                            "languages": i18n.languages(),
                            "messages": i18n.messages(lang)})
        else:
            self._send(404, b"not found", "text/plain")

    def do_POST(self):
        """Remote stats receiver (reference PlayUIServer remote-receiver
        route; fed by storage.remote.RemoteUIStatsStorageRouter)."""
        url = urlparse(self.path)
        st = type(self).storage
        if url.path == "/api/tsne/upload":
            # reference TsneModule POST /tsne/upload: store named coord sets
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length))
                name = str(body["session"])
                entry = _sanitize_tsne(body["coords"], body.get("labels"))
                ts = type(self).tsne_sessions
                if ts is None:
                    ts = type(self).tsne_sessions = {}
                ts[name] = entry
                self._json({"ok": True, "n": len(entry["coords"])})
            except Exception as e:
                self._send(400, f"bad upload: {e}".encode(), "text/plain")
            return
        if url.path not in ("/remoteReceive", "/remoteReceive/") or st is None:
            self._send(404, b"not found", "text/plain")
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            record = json.loads(self.rfile.read(length))
            if record.get("kind") == "static":
                st.put_static_info(record)
            else:
                st.put_update(record)
            self._json({"ok": True})
        except Exception as e:
            self._send(400, f"bad record: {e}".encode(), "text/plain")


class UIServer:
    """Singleton UI server (reference UIServer.getInstance() /
    PlayUIServer.java:51). ``attach`` a storage, then browse
    ``http://localhost:<port>/``."""

    _instance: Optional["UIServer"] = None

    def __init__(self, port: int = 9000, bind_address: str = "127.0.0.1"):
        # loopback by default: /remoteReceive accepts unauthenticated writes,
        # so exposing beyond the host is a deliberate opt-in
        self.port = port
        self.bind_address = bind_address
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.storage = None
        self._tsne_sessions: dict = {}

    @classmethod
    def get_instance(cls, port: int = 9000,
                     bind_address: str = "127.0.0.1") -> "UIServer":
        if cls._instance is None:
            cls._instance = cls(port, bind_address)
        elif (bind_address != cls._instance.bind_address
              or port != cls._instance.port):
            # the singleton keeps first-caller settings; an explicit later
            # request for a different bind must not be silently dropped
            log.warning(
                "UIServer singleton already bound to %s:%s; ignoring request "
                "for %s:%s (stop() it first to rebind)",
                cls._instance.bind_address, cls._instance.port,
                bind_address, port)
        return cls._instance

    def attach(self, storage):
        self.storage = storage
        handler = type("BoundHandler", (_Handler,),
                       {"storage": storage,
                        "tsne_sessions": self._tsne_sessions})
        if self._httpd is None:
            self._httpd = ThreadingHTTPServer((self.bind_address, self.port),
                                              handler)
            self.port = self._httpd.server_address[1]
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True)
            self._thread.start()
        else:
            self._httpd.RequestHandlerClass = handler
        return self

    def upload_tsne(self, session: str, coords, labels=None):
        """In-process equivalent of POST /api/tsne/upload (reference
        UIServer-side of TsneModule): accepts a (n, 2+) array-like."""
        self._tsne_sessions[session] = _sanitize_tsne(coords, labels)
        return self

    def detach(self):
        self.storage = None

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if type(self)._instance is self:
            type(self)._instance = None

    @property
    def address(self) -> str:
        return f"http://localhost:{self.port}/"


def dashboard_html() -> str:
    """The dashboard page as a string (for tests / static export)."""
    return _DASHBOARD_HTML
