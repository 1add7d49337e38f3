"""Static HTML experiment report — the MLflow *UI* role, zero-dependency.

The reference's workflow inspects training curves and HPO children in the
MLflow web UI (runs table, per-run params, metric line charts —
``01_hyperopt_single_machine_model.py:253-262`` queries what the UI shows).
The in-tree tracker stores the same data (``meta.json`` / ``params.json`` /
``metrics.jsonl``); this module renders one experiment into a single
self-contained HTML file: a runs table (nested HPO children indented under
their parent, the parent/child hierarchy of
``02_hyperopt_distributed_model.py:240-260``) and one inline-SVG line chart
per metric overlaying every run that logged it.

No JS, no external assets — the file opens anywhere, ships as a run artifact,
and diffs cleanly in review. Write-path friends: :class:`ddw_tpu_torch.tracking.Run`
(data), ``python -m ddw_tpu_torch.tracking <root> report`` (CLI).
"""

from __future__ import annotations

import html
import math
import os
import time
from pathlib import PurePath

from ddw_tpu_torch.tracking.tracker import Run

# Categorical palette (colorblind-safe Okabe-Ito), cycled per run.
_COLORS = ["#0072B2", "#E69F00", "#009E73", "#D55E00", "#CC79A7",
           "#56B4E9", "#F0E442", "#000000"]

_CSS = """
body { font-family: system-ui, sans-serif; margin: 2rem; color: #222; }
h1 { font-size: 1.3rem; } h2 { font-size: 1.05rem; margin-top: 2rem; }
table { border-collapse: collapse; font-size: 0.85rem; }
th, td { border: 1px solid #ddd; padding: 0.3rem 0.55rem; text-align: left; }
th { background: #f5f5f5; } tr.child td:first-child { padding-left: 1.6rem; }
.status-FINISHED { color: #1a7f37; } .status-FAILED { color: #cf222e; }
.status-RUNNING { color: #9a6700; }
.charts { display: flex; flex-wrap: wrap; gap: 1.2rem; }
figure { margin: 0; } figcaption { font-size: 0.8rem; color: #555; }
.legend { font-size: 0.75rem; } .legend span { margin-right: 0.9rem; }
.swatch { display: inline-block; width: 0.7em; height: 0.7em;
          margin-right: 0.25em; }
"""


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _svg_chart(series: list[tuple[str, str, list[tuple[int, float]]]],
               width: int = 420, height: int = 240) -> str:
    """One SVG line chart. ``series`` = [(label, color, [(step, value), ...])];
    the label becomes each mark's hover ``<title>``. Non-finite values (a
    diverged run logging NaN/inf) are dropped so one bad run can't poison the
    whole chart's scaling."""
    pad_l, pad_r, pad_t, pad_b = 52, 10, 8, 24
    series = [(lb, c, [(x, y) for x, y in s if math.isfinite(y)])
              for lb, c, s in series]
    series = [(lb, c, s) for lb, c, s in series if s]
    pts = [p for _, _, s in series for p in s]
    if not pts:
        return ("<svg viewBox='0 0 160 24' width='160' height='24'>"
                "<text x='0' y='16' font-size='11'>no finite values</text></svg>")
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    x0, x1 = min(xs), max(xs)
    y0, y1 = min(ys), max(ys)
    if x1 == x0:
        x1 = x0 + 1
    if y1 == y0:  # flat series: pad so the line sits mid-chart
        y0, y1 = y0 - 0.5, y1 + 0.5
    iw, ih = width - pad_l - pad_r, height - pad_t - pad_b

    def sx(x):
        return pad_l + (x - x0) / (x1 - x0) * iw

    def sy(y):
        return pad_t + (1 - (y - y0) / (y1 - y0)) * ih

    out = [f'<svg viewBox="0 0 {width} {height}" width="{width}" '
           f'height="{height}" role="img">']
    # frame + y min/max + x min/max labels
    out.append(f'<rect x="{pad_l}" y="{pad_t}" width="{iw}" height="{ih}" '
               f'fill="none" stroke="#ccc"/>')
    out.append(f'<text x="{pad_l - 6}" y="{pad_t + 10}" text-anchor="end" '
               f'font-size="10">{_fmt(y1)}</text>')
    out.append(f'<text x="{pad_l - 6}" y="{height - pad_b}" text-anchor="end" '
               f'font-size="10">{_fmt(y0)}</text>')
    out.append(f'<text x="{pad_l}" y="{height - 6}" font-size="10">{x0}</text>')
    out.append(f'<text x="{width - pad_r}" y="{height - 6}" text-anchor="end" '
               f'font-size="10">{x1}</text>')
    for label, color, s in series:
        title = f"<title>{html.escape(label)}</title>"
        if len(s) == 1:
            x, y = s[0]
            out.append(f'<circle cx="{sx(x):.1f}" cy="{sy(y):.1f}" r="2.5" '
                       f'fill="{color}">{title}</circle>')
        else:
            coords = " ".join(f"{sx(x):.1f},{sy(y):.1f}" for x, y in s)
            out.append(f'<polyline points="{coords}" fill="none" '
                       f'stroke="{color}" stroke-width="1.5">{title}</polyline>')
    out.append("</svg>")
    return "".join(out)


def _runs_in_tree_order(exp_dir: str) -> list[tuple[Run, dict, int]]:
    """(run, meta, depth) rows, depth-first so every run sits under its parent
    at any nesting level (HPO trial -> retry/sub-trial chains included).

    Reads run dirs directly (no :class:`Tracker`): the report is a read-only
    consumer and must neither import jax nor create directories (same
    discipline as the CLI's ``_exp_dir``). meta.json is parsed once per run
    and returned so callers don't re-read it per cell."""
    runs = [Run(os.path.join(exp_dir, d), d, writable=False)
            for d in sorted(os.listdir(exp_dir))
            if os.path.exists(os.path.join(exp_dir, d, "meta.json"))]
    metas = {r.run_id: r.meta() for r in runs}
    by_parent: dict[str | None, list[Run]] = {}
    for r in runs:
        by_parent.setdefault(metas[r.run_id].get("parent_run_id"), []).append(r)
    known = set(metas)
    rows: list[tuple[Run, dict, int]] = []
    emitted: set[str] = set()

    def emit(r: Run, depth: int) -> None:
        if r.run_id in emitted:  # corrupt parent cycle: emit once, don't recurse
            return
        emitted.add(r.run_id)
        rows.append((r, metas[r.run_id], depth))
        for child in by_parent.get(r.run_id, []):
            emit(child, depth + 1)

    for r in runs:
        if metas[r.run_id].get("parent_run_id") not in known:
            emit(r, 0)
    for r in runs:  # anything a cycle kept unreachable still gets a row
        emit(r, 0)
    return rows


def render_report(root: str, experiment: str = "default",
                  metrics: list[str] | None = None,
                  include_sys: bool = True,
                  max_metric_cols: int = 8) -> str:
    """Render one experiment to an HTML string.

    ``metrics`` restricts the training-metric chart set (default: every
    logged key). ``sys.*`` utilization series — the Ganglia role — render in
    their own "System utilization" section so the cluster-health story lives
    in the same artifact as the training curves (reference keeps them in a
    separate Ganglia tab, ``04_monitoring_and_optimization.py:25-29``);
    ``include_sys=False`` suppresses that section. Runs that recorded a
    profiler trace (``TrainCfg.trace_dir`` → the ``trace_dir`` param) get a
    link to it in the runs table — the Horovod-Timeline artifact, one click
    from the run row. The runs table shows at most ``max_metric_cols`` metric
    columns and says how many were cut.
    """
    exp_dir = os.path.join(root, experiment)
    if not os.path.isdir(exp_dir):
        raise FileNotFoundError(f"no experiment {experiment!r} under {root}")
    rows = _runs_in_tree_order(exp_dir)

    # one metrics.jsonl parse per run: series for the charts, last value per
    # key for the table
    all_keys: list[str] = []
    series_of: dict[str, dict[str, list[tuple[int, float]]]] = {}
    finals: dict[str, dict[str, float]] = {}
    for r, _, _ in rows:
        s = r.metric_series()
        series_of[r.run_id] = s
        finals[r.run_id] = {k: v[-1][1] for k, v in s.items()}
        for k in s:
            if k not in all_keys:
                all_keys.append(k)
    chart_keys = [k for k in (metrics if metrics is not None else all_keys)
                  if not k.startswith("sys.")]
    sys_keys = ([k for k in all_keys if k.startswith("sys.")]
                if include_sys else [])

    parts = ["<!doctype html><html><head><meta charset='utf-8'>",
             f"<title>{html.escape(experiment)} — ddw_tpu_torch report</title>",
             f"<style>{_CSS}</style></head><body>",
             f"<h1>Experiment <code>{html.escape(experiment)}</code></h1>",
             f"<p>{len(rows)} runs · generated "
             f"{time.strftime('%Y-%m-%d %H:%M:%S')} · root "
             f"<code>{html.escape(os.path.abspath(root))}</code></p>"]

    # ---- runs table
    all_metric_keys = [k for k in all_keys if not k.startswith("sys.")]
    metric_cols = all_metric_keys[:max_metric_cols]
    n_cut = len(all_metric_keys) - len(metric_cols)
    # trace column only when some run recorded one (param logged by the
    # trainer when TrainCfg.trace_dir is set)
    params_of = {r.run_id: r.params() for r, _, _ in rows}
    has_trace = any("trace_dir" in p for p in params_of.values())
    parts.append("<h2>Runs</h2><table><tr><th>run</th><th>name</th>"
                 "<th>status</th>" + ("<th>trace</th>" if has_trace else "")
                 + "<th>params</th>"
                 + "".join(f"<th>{html.escape(k)}</th>" for k in metric_cols)
                 + (f"<th>+{n_cut} more</th>" if n_cut else "")
                 + "</tr>")
    color_of: dict[str, str] = {}
    for i, (r, meta, depth) in enumerate(rows):
        color_of[r.run_id] = _COLORS[i % len(_COLORS)]
        status = meta.get("status", "?")
        run_params = params_of[r.run_id]
        params = " ".join(f"{html.escape(str(k))}={html.escape(_fmt(v))}"
                          for k, v in sorted(run_params.items())
                          # the dedicated trace column shows these
                          if k != "trace_dir" and not k.endswith(".trace_dir"))
        trace_cell = ""
        if has_trace:
            td = run_params.get("trace_dir")
            if td:
                # percent-encoded file:// URI — raw paths with '#'/space would
                # truncate or 404 in the browser
                href = (PurePath(str(td)).as_uri()
                        if os.path.isabs(str(td)) else str(td))
                trace_cell = f"<td><a href='{html.escape(href)}'>profile</a></td>"
            else:
                trace_cell = "<td></td>"
        cells = "".join(
            f"<td>{_fmt(finals[r.run_id][k]) if k in finals[r.run_id] else ''}</td>"
            for k in metric_cols)
        indent = (f" style='padding-left:{0.55 + 1.6 * depth:.2f}rem'"
                  if depth > 1 else "")
        parts.append(
            f"<tr class='{'child' if depth else ''}'>"
            f"<td{indent}><span class='swatch' "
            f"style='background:{color_of[r.run_id]}'>"
            f"</span><code>{html.escape(r.run_id)}</code></td>"
            f"<td>{html.escape(meta.get('name', ''))}</td>"
            f"<td class='status-{html.escape(status)}'>{html.escape(status)}</td>"
            f"{trace_cell}<td>{params}</td>{cells}"
            + ("<td></td>" if n_cut else "") + "</tr>")
    parts.append("</table>")

    # ---- charts: one per metric, overlaying all runs that logged it
    def chart_set(keys: list[str]) -> list[str]:
        charts = []
        for key in keys:
            series = []
            for r, _, _ in rows:
                hist = series_of[r.run_id].get(key)
                if hist:
                    series.append((r.run_id, color_of[r.run_id], hist))
            if series:
                charts.append(
                    f"<figure>{_svg_chart(series)}"
                    f"<figcaption>{html.escape(key)}</figcaption></figure>")
        return charts

    legend = "".join(
        f"<span><span class='swatch' style='background:{color_of[r.run_id]}'>"
        f"</span><code>{html.escape(r.run_id)}</code></span>"
        for r, _, _ in rows)
    charts = chart_set(chart_keys)
    if charts:
        parts.append("<h2>Metrics</h2>")
        parts.append(f"<div class='legend'>{legend}</div>")
        parts.append(f"<div class='charts'>{''.join(charts)}</div>")

    # ---- utilization: the Ganglia dashboards next to the training curves
    sys_charts = chart_set(sys_keys)
    if sys_charts:
        parts.append("<h2>System utilization</h2>")
        parts.append(f"<div class='legend'>{legend}</div>")
        parts.append(f"<div class='charts'>{''.join(sys_charts)}</div>")

    parts.append("</body></html>")
    return "".join(parts)


def write_report(root: str, experiment: str = "default",
                 out_path: str | None = None,
                 metrics: list[str] | None = None,
                 include_sys: bool = True) -> str:
    """Render and write the report; returns the output path."""
    out_path = out_path or os.path.join(root, f"{experiment}_report.html")
    html_text = render_report(root, experiment, metrics, include_sys)
    with open(out_path, "w") as f:
        f.write(html_text)
    return out_path
