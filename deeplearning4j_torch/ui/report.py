"""Static HTML training report from a StatsStorage.

The serverless replacement for the reference's Vert.x web UI
(``deeplearning4j-ui``): one dependency-free HTML file with the loss
curve and throughput charts (inline SVG, light+dark via CSS custom
properties, crosshair hover, data table for accessibility), written at
the end of — or during — a run.  Port of
``deeplearning4j_tpu/ui/report.py``: the same code, host only.
"""
from __future__ import annotations

import html
import json
from typing import List, Optional

from deeplearning4j_torch.ui.stats import StatsStorage

# Validated single-series palette (see the repo's chart-style defaults):
# series blue light/dark on the matching surfaces; text wears text tokens.
_CSS = """
.viz-root { color-scheme: light;
  --surface-1:#fcfcfb; --text-primary:#0b0b0b; --text-secondary:#52514e;
  --grid:#e4e3df; --series-1:#2a78d6;
  font:14px/1.45 system-ui,sans-serif; background:var(--surface-1);
  color:var(--text-primary); max-width:880px; margin:2rem auto; padding:0 1rem; }
@media (prefers-color-scheme: dark) { .viz-root { color-scheme: dark;
  --surface-1:#1a1a19; --text-primary:#ffffff; --text-secondary:#c3c2b7;
  --grid:#33322f; --series-1:#3987e5; } }
.viz-root h1 { font-size:1.25rem; } .viz-root h2 { font-size:1rem; }
.viz-root .meta { color:var(--text-secondary); }
.viz-root svg { display:block; width:100%; height:auto; }
.viz-root .tip { position:fixed; pointer-events:none; background:var(--surface-1);
  border:1px solid var(--grid); padding:2px 6px; border-radius:4px;
  font-size:12px; display:none; }
.viz-root table { border-collapse:collapse; font-size:12px; }
.viz-root td, .viz-root th { border:1px solid var(--grid); padding:2px 8px;
  text-align:right; }
"""

_JS = """
document.querySelectorAll('svg[data-pts]').forEach(svg => {
  const pts = JSON.parse(svg.dataset.pts);
  const tip = document.getElementById('tip');
  svg.addEventListener('mousemove', ev => {
    const r = svg.getBoundingClientRect();
    const fx = (ev.clientX - r.left) / r.width;
    let best = 0, bd = 1e9;
    pts.forEach((p, i) => { const d = Math.abs(p[0] - fx);
                            if (d < bd) { bd = d; best = i; } });
    const p = pts[best];
    tip.style.display = 'block';
    tip.style.left = (ev.clientX + 12) + 'px';
    tip.style.top = (ev.clientY - 10) + 'px';
    tip.textContent = 'iter ' + p[2] + ': ' + p[3];
  });
  svg.addEventListener('mouseleave', () => tip.style.display = 'none');
});
"""


def _line_chart(xs: List[float], ys: List[float], title: str,
                unit: str) -> str:
    """One single-series 2px line on a recessive grid (no legend — the
    title names the series), with hover data attached."""
    if not xs:
        return f"<h2>{html.escape(title)}</h2><p class=meta>no data</p>"
    w, h, pad = 860, 220, 36
    x0, x1 = min(xs), max(xs) or 1
    y0, y1 = min(ys), max(ys)
    if y1 == y0:
        y1 = y0 + 1
    sx = lambda v: pad + (v - x0) / (x1 - x0 or 1) * (w - 2 * pad)
    sy = lambda v: h - pad - (v - y0) / (y1 - y0) * (h - 2 * pad)
    path = " ".join(f"{'M' if i == 0 else 'L'}{sx(x):.1f},{sy(y):.1f}"
                    for i, (x, y) in enumerate(zip(xs, ys)))
    grid = "".join(
        f'<line x1="{pad}" x2="{w-pad}" y1="{sy(y0+f*(y1-y0)):.1f}" '
        f'y2="{sy(y0+f*(y1-y0)):.1f}" stroke="var(--grid)" '
        'stroke-width="1"/>' for f in (0, 0.5, 1))
    labels = (
        f'<text x="{pad-6}" y="{sy(y0):.1f}" text-anchor="end" '
        f'fill="var(--text-secondary)" font-size="11">{y0:.4g}</text>'
        f'<text x="{pad-6}" y="{sy(y1)+4:.1f}" text-anchor="end" '
        f'fill="var(--text-secondary)" font-size="11">{y1:.4g}</text>'
        f'<text x="{pad}" y="{h-pad+16}" fill="var(--text-secondary)" '
        f'font-size="11">iteration {x0:.0f}</text>'
        f'<text x="{w-pad}" y="{h-pad+16}" text-anchor="end" '
        f'fill="var(--text-secondary)" font-size="11">{x1:.0f}</text>')
    pts = [[(sx(x) / w), (sy(y) / h), int(x), f"{y:.5g} {unit}"]
           for x, y in zip(xs, ys)]
    return (
        f"<h2>{html.escape(title)}</h2>"
        f'<svg viewBox="0 0 {w} {h}" role="img" '
        f'aria-label="{html.escape(title)}" '
        f"data-pts='{json.dumps(pts)}'>{grid}"
        f'<path d="{path}" fill="none" stroke="var(--series-1)" '
        'stroke-width="2" stroke-linejoin="round"/>'
        f"{labels}</svg>")


def _fmt_val(v) -> str:
    try:
        return f"{float(v):.6g}"
    except (TypeError, ValueError):
        return html.escape(str(v))


def _telemetry_section(snap: dict) -> str:
    """Tables from one ``telemetry_snapshot`` record (the jsonl form a
    ``TelemetryListener(storage=...)`` appends per epoch): scalar series,
    then histograms with their bucket-derived p50/p95/p99."""
    scalars = {**snap.get("counters", {}), **snap.get("gauges", {})}
    rows = "".join(
        f"<tr><td style=text-align:left>{html.escape(k)}</td>"
        f"<td>{_fmt_val(v)}</td></tr>"
        for k, v in sorted(scalars.items()))
    hrows = "".join(
        f"<tr><td style=text-align:left>{html.escape(k)}</td>"
        f"<td>{h.get('count', 0)}</td><td>{_fmt_val(h.get('sum', 0))}</td>"
        f"<td>{_fmt_val(h.get('p50'))}</td><td>{_fmt_val(h.get('p95'))}</td>"
        f"<td>{_fmt_val(h.get('p99'))}</td></tr>"
        for k, h in sorted(snap.get("histograms", {}).items()))
    out = "<h2>Telemetry</h2>"
    if rows:
        out += ("<table><tr><th>series</th><th>value</th></tr>"
                + rows + "</table>")
    if hrows:
        out += ("<table><tr><th>histogram</th><th>count</th><th>sum</th>"
                "<th>p50</th><th>p95</th><th>p99</th></tr>"
                + hrows + "</table>")
    return out


def render_report(storage: StatsStorage, path: str,
                  title: str = "Training report",
                  trace_path: Optional[str] = None) -> Optional[str]:
    """Write the HTML report; returns the path (None if no records).

    The storage may interleave per-iteration stats records with
    ``telemetry_snapshot`` records (``TelemetryListener(storage=...)``);
    the latest snapshot renders as a metrics table.  ``trace_path``
    links an exported span trace (``SpanTracer.export_jsonl``) for
    ``about://tracing``-style viewers."""
    recs = storage.records()
    if not recs:
        return None
    iter_recs = [r for r in recs if "iteration" in r and "loss" in r]
    snaps = [r for r in recs if r.get("type") == "telemetry_snapshot"]
    its = [r["iteration"] for r in iter_recs]
    losses = [r["loss"] for r in iter_recs]
    thr = [(r["iteration"], r["examples_per_sec"]) for r in iter_recs
           if "examples_per_sec" in r]
    rows = "".join(
        f"<tr><td>{r['iteration']}</td><td>{r['epoch']}</td>"
        f"<td>{r['loss']:.6g}</td>"
        f"<td>{r.get('examples_per_sec', '')}</td></tr>"
        for r in iter_recs)
    meta = (f"{len(iter_recs)} iterations · final loss {losses[-1]:.6g}"
            if iter_recs else "no iteration records")
    if trace_path:
        meta += (' · <a href="' + html.escape(str(trace_path), quote=True)
                 + '">span trace (load in about://tracing / Perfetto)'
                   '</a>')
    body = (
        f"<h1>{html.escape(title)}</h1>"
        f"<p class=meta>{meta}</p>"
        + (_line_chart(its, losses, "Loss", "loss") if iter_recs else "")
        + (_line_chart([t[0] for t in thr], [t[1] for t in thr],
                       "Throughput", "ex/s") if thr else "")
        + (_telemetry_section(snaps[-1]) if snaps else "")
        + ("<details><summary>Data table</summary><table>"
           "<tr><th>iter</th><th>epoch</th><th>loss</th><th>ex/s</th></tr>"
           + rows + "</table></details>" if iter_recs else "")
        + '<div id="tip" class="tip"></div>')
    doc = (f"<!doctype html><meta charset=utf-8><title>{html.escape(title)}"
           f"</title><style>{_CSS}</style>"
           f'<div class="viz-root">{body}</div><script>{_JS}</script>')
    with open(path, "w") as f:
        f.write(doc)
    return path
