"""Render an obs JSONL event log (or a flight-recorder dump) as a
human-readable post-mortem report (counterpart of the JAX package's
``tools/obs_report.py``; the same text for the same inputs).

Usage:
    python -m deeplearning4j_tpu_torch.tools.obs_report RUN.jsonl [flightrec-w03 ...] [--top N]

Inputs are files written by ``obs.EventLog`` (JSON lines of span/event
records) and/or ``obs.FlightRecorder.flush`` (one JSON object with an
``events`` list) — with a ``LocalFSBackend`` store these are plain files
in the store directory. Multiple inputs merge into one report; records
appearing in several inputs (the crash ring overlaps the event log when
both came from the same process) are counted once.

Sections:
  - **Per-step phase breakdown** — the ``train.*`` spans (data-wait /
    host / device) aggregated: count, total/mean/p50/p95/max ms;
  - **Span summary** — every span name aggregated the same way;
  - **Slowest spans** — the top-N individual spans with their attrs;
  - **Crash-ring tail** — the newest records of each flight dump, with
    its flush reason (what the victim was doing in its last seconds);
  - **Events** — non-span lifecycle breadcrumbs (generation boundaries,
    checkpoint commits, watchdog diagnostics).
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.obs.flight import dump_tail_summary


def load_records(path: str) -> Tuple[List[dict], Optional[dict]]:
    """Parse one input file. Returns ``(records, dump)`` — ``dump`` is the
    flight-dump envelope when the file is one (its events are ALSO in
    ``records``), else None. Unparseable lines are skipped (a crashed
    writer may leave a torn tail)."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{"):
        try:
            obj = json.loads(stripped)
            if isinstance(obj, dict) and isinstance(obj.get("events"), list):
                return list(obj["events"]), obj
        except ValueError:
            pass
    records = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if isinstance(rec, dict):
            records.append(rec)
    return records, None


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]


def _agg_table(spans: List[dict], title: str) -> List[str]:
    by_name: Dict[str, List[float]] = {}
    for s in spans:
        by_name.setdefault(s.get("name", "?"), []).append(
            float(s.get("dur_ms", 0.0)))
    if not by_name:
        return []
    lines = [title, "-" * len(title),
             f"{'span':<28} {'count':>7} {'total_ms':>10} {'mean_ms':>9} "
             f"{'p50_ms':>8} {'p95_ms':>8} {'max_ms':>9}"]
    for name in sorted(by_name, key=lambda n: -sum(by_name[n])):
        ds = sorted(by_name[name])
        total = sum(ds)
        lines.append(
            f"{name:<28} {len(ds):>7} {total:>10.2f} "
            f"{total / len(ds):>9.3f} {_percentile(ds, 0.50):>8.3f} "
            f"{_percentile(ds, 0.95):>8.3f} {ds[-1]:>9.2f}")
    lines.append("")
    return lines


def _fmt_attrs(attrs: Optional[dict]) -> str:
    if not attrs:
        return ""
    return " ".join(f"{k}={v}" for k, v in attrs.items())


def render_report(records: List[dict], dumps: Optional[List[dict]] = None,
                  top: int = 10) -> str:
    """The report as one string (see module docstring for the sections)."""
    spans = [r for r in records if r.get("kind") == "span"]
    events = [r for r in records if r.get("kind") == "event"]
    lines: List[str] = [
        "observability report",
        "====================",
        f"{len(records)} records ({len(spans)} spans, {len(events)} "
        f"events)", ""]
    phase_spans = [s for s in spans
                   if str(s.get("name", "")).startswith("train.")]
    lines += _agg_table(phase_spans, "Per-step phase breakdown (train.*)")
    lines += _agg_table(spans, "Span summary (all)")
    slowest = sorted(spans, key=lambda s: -float(s.get("dur_ms", 0.0)))[:top]
    if slowest:
        lines += ["Slowest spans", "-------------"]
        for s in slowest:
            lines.append(f"{float(s.get('dur_ms', 0.0)):>10.2f} ms  "
                         f"{s.get('name', '?')}  {_fmt_attrs(s.get('attrs'))}")
        lines.append("")
    for dump in dumps or []:
        # one-liner format shared with CrashRecord.flight_tail
        head = (f"Crash-ring tail — worker {dump.get('worker_id', '?')} "
                f"(flushed: {dump.get('reason', '?')})")
        lines += [head, "-" * len(head)]
        for line in dump_tail_summary(dump, n=top)[1:]:
            lines.append("  " + line)
        lines.append("")
    if events:
        lines += ["Events", "------"]
        for r in events[-top * 2:]:
            lines.append(f"  {r.get('name', '?')}  "
                         f"{_fmt_attrs(r.get('attrs'))}")
        lines.append("")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv if argv is None else argv
    top = 10
    paths = []
    args = list(argv[1:])
    while args:
        a = args.pop(0)
        if a == "--top":
            if not args:
                print("--top needs a value", file=sys.stderr)
                return 2
            top = int(args.pop(0))
        else:
            paths.append(a)
    if not paths:
        print(__doc__.strip(), file=sys.stderr)
        return 2
    records: List[dict] = []
    seen = set()
    dumps: List[dict] = []
    for p in paths:
        recs, dump = load_records(p)
        for rec in recs:
            key = json.dumps(rec, sort_keys=True, default=str)
            if key not in seen:
                seen.add(key)
                records.append(rec)
        if dump is not None:
            dumps.append(dump)
    records.sort(key=lambda r: r.get("wall", 0.0))
    print(render_report(records, dumps, top=top))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
