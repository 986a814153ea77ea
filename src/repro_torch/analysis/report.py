"""Render EXPERIMENTS.md §Dry-run and §Roofline tables from the committed
dry-run artifacts (experiments/dryrun/*.json).

    PYTHONPATH=src python -m repro_torch.analysis.report > /tmp/tables.md
"""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
DRYRUN = ROOT / "experiments" / "dryrun"


def load_all():
    rows = []
    for f in sorted(DRYRUN.glob("*.json")):
        rows.append(json.loads(f.read_text()))
    return rows


def fmt_ms(x):
    return f"{x*1e3:.1f}"


def dryrun_table(rows):
    out = ["| arch | shape | mesh | chips | GiB/chip | fits | collectives "
           "(wire GiB/chip) | compile s |",
           "|---|---|---|---|---|---|---|---|"]
    for d in rows:
        if d.get("status") == "skipped":
            out.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | — | — "
                       f"| SKIP | {d['reason']} | — |")
            continue
        if d.get("status") != "ok":
            out.append(f"| {d['arch']} | {d['shape']} | {d['mesh']} | — | — "
                       f"| ERROR | {d.get('error','')[:60]} | — |")
            continue
        m = d["memory"]
        coll = d["hlo"]["collectives"]
        cstr = " ".join(f"{k}:{v['wire_bytes']/2**30:.2f}"
                        for k, v in sorted(coll.items()))
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} | {d['n_chips']} "
            f"| {m['per_chip_bytes']/2**30:.2f} "
            f"| {'Y' if m['fits_hbm'] else 'N'} | {cstr or '—'} "
            f"| {d['compile_s']} |")
    return "\n".join(out)


def roofline_table(rows):
    out = ["| arch | shape | compute ms | memory ms | collective ms | "
           "dominant | MODEL_FLOPS/chip TF | useful ratio | note |",
           "|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        if d.get("mesh") != "pod" or d.get("status") != "ok":
            continue
        r = d["roofline"]
        mf = d["model_flops_global"] / d["n_chips"] / 1e12
        dom = r["dominant"]
        note = {
            "compute": "MXU-bound; overlap/fusion won't help much",
            "memory": "HBM-bound; cut bytes (dtype, fusion, layout)",
            "collective": "ICI-bound; reshard or overlap collectives",
        }[dom]
        out.append(
            f"| {d['arch']} | {d['shape']} | {fmt_ms(r['compute_s'])} "
            f"| {fmt_ms(r['memory_s'])} | {fmt_ms(r['collective_s'])} "
            f"| **{dom}** | {mf:.1f} | {d['useful_flops_ratio']:.2f} "
            f"| {note} |")
    return "\n".join(out)


# ===========================================================================
# Planner drift report (predicted vs measured serving outcomes)
# ===========================================================================
def drift_report(plan_entry, serve_stats) -> dict:
    """Compare the winning plan's predictions against a serve run's
    measurements — the feedback signal planner changes are judged by.

    Duck-typed on attribute names (a ``GenPlanEntry`` and a
    ``ServeStats``, but anything carrying the fields works), so this
    module stays import-light.  Returns ``{"rows": [...]}`` where each
    row has ``metric`` / ``predicted`` / ``measured`` / ``ratio``
    (measured ÷ predicted; None when the prediction is zero or absent:
    no drift is computable)."""
    pairs = [
        ("ttft_s", "predicted_ttft_s", "ttft_p50_s"),
        ("tpot_s", "predicted_tpot_s", "tpot_p50_s"),
        ("throughput_tps", "predicted_throughput_tps", "tokens_per_s"),
        ("peak_bytes", "predicted_peak_bytes", "peak_bytes"),
    ]
    rows = []
    for metric, p_attr, m_attr in pairs:
        pred = getattr(plan_entry, p_attr, None)
        meas = getattr(serve_stats, m_attr, None)
        ratio = (meas / pred) if pred and meas is not None else None
        rows.append({"metric": metric, "predicted": pred,
                     "measured": meas, "ratio": ratio})
    return {"rows": rows}


def format_drift(report: dict) -> str:
    """Aligned text table for a ``drift_report`` result (serve.py prints
    this at the end of a run)."""
    lines = ["planner drift (predicted vs measured, ratio = meas/pred):",
             f"  {'metric':<16} {'predicted':>12} {'measured':>12} "
             f"{'ratio':>7}"]
    for row in report["rows"]:
        def num(v):
            if v is None:
                return "—"
            return f"{v:,.0f}" if abs(v) >= 1000 else f"{v:.4g}"
        ratio = "—" if row["ratio"] is None else f"{row['ratio']:.2f}x"
        lines.append(f"  {row['metric']:<16} {num(row['predicted']):>12} "
                     f"{num(row['measured']):>12} {ratio:>7}")
    return "\n".join(lines)


# ===========================================================================
# Peak-breakdown attribution (per-owner byte shares at the ledger peak)
# ===========================================================================
def peak_breakdown_report(stats) -> dict:
    """Attribute the run's ledger peak to its resident tiers.

    Duck-typed like ``drift_report``: ``stats`` is anything carrying
    ``peak_bytes`` and a ``peak_breakdown`` dict (``RunStats`` or
    ``ServeStats``).  The breakdown is the by-owner snapshot taken under
    the ledger lock at the instant the peak was set, so the shares sum
    EXACTLY to ``peak_bytes`` — a mismatch means a ledger bug, and the
    report surfaces it as a non-empty ``unattributed`` row rather than
    hiding it.  Returns ``{"peak_bytes", "rows": [...], "unattributed"}``
    with rows sorted largest share first."""
    peak = getattr(stats, "peak_bytes", 0) or 0
    breakdown = dict(getattr(stats, "peak_breakdown", None) or {})
    rows = [{"owner": o, "bytes": b,
             "share": (b / peak) if peak else 0.0}
            for o, b in sorted(breakdown.items(),
                               key=lambda kv: (-kv[1], kv[0]))]
    return {"peak_bytes": peak, "rows": rows,
            "unattributed": peak - sum(breakdown.values())}


def format_peak_breakdown(report: dict) -> str:
    """Aligned text table for ``peak_breakdown_report`` (serve.py prints
    this under the end-of-run summary)."""
    peak = report["peak_bytes"]
    lines = [f"ledger peak attribution (peak = {peak:,} bytes):",
             f"  {'owner':<16} {'bytes':>14} {'share':>7}"]
    if not report["rows"]:
        lines.append("  (no ledger charges recorded)")
    for row in report["rows"]:
        lines.append(f"  {row['owner']:<16} {row['bytes']:>14,} "
                     f"{row['share']:>6.1%}")
    if report["unattributed"]:
        lines.append(f"  {'UNATTRIBUTED':<16} "
                     f"{report['unattributed']:>14,} "
                     f"{'!':>7}  (ledger bug: shares must sum to peak)")
    return "\n".join(lines)


def main():
    rows = load_all()
    ok = [d for d in rows if d.get("status") == "ok"]
    print("## §Dry-run (auto-generated; full artifacts in "
          "experiments/dryrun/)\n")
    print(dryrun_table(rows))
    print(f"\n{len(ok)} combinations compiled "
          f"({sum(1 for d in rows if d.get('status')=='skipped')} documented "
          "skips).\n")
    print("## §Roofline (single-pod mesh, 256 chips)\n")
    print(roofline_table(rows))


if __name__ == "__main__":
    main()
