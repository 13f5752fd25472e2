#!/usr/bin/env python
"""Render the benchmark result CSVs into comparison figures.

Parity with the reference's ``scripts/plot_all.py`` (which renders its
``result_bop.csv``/``result_lr.csv`` against the GPU systems): this
renders ``result_{bop,lr,tsqr,gemm,ooc}.csv`` against the
reference's published 4-GPU / 8-GPU numbers (BASELINE.md tables, from
the reference's ``scripts/result_bop.csv`` and ``result_lr.csv``).

    python scripts/plot_all.py [--out plots/]

writes one PNG per benchmark. Reference numbers are embedded constants
(the reference hardware isn't re-runnable here); nums_tpu numbers are
read live from the CSVs so the figures track the committed artifacts.
"""

import argparse
import csv
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

# Validated categorical palette (fixed slot order) on the light surface.
SURFACE = "#fcfcfb"
TEXT = "#0b0b0b"
TEXT2 = "#52514e"
GRID = "#e4e3df"
C_OURS = "#2a78d6"   # slot 1 blue  — nums_tpu
C_4GPU = "#eb6834"   # slot 2 orange — CupyParallelSystem (4 GPU)
C_8GPU = "#1baf7a"   # slot 3 aqua  — CupyNcclActorSystem (8 GPU)

# Reference results, BASELINE.md (fp32, d=1000). N -> seconds.
BOP_4GPU = {125000: 0.0065, 250000: 0.0113, 1250000: 0.0522,
            2500000: 0.0954, 5000000: 0.2378, 10000000: 0.5101}
BOP_8GPU = {125000: 0.0412, 250000: 0.0432, 1250000: 0.0480,
            2500000: 0.0714, 5000000: 0.1099, 10000000: 0.2640,
            20000000: 0.5349}
LR_4GPU = {125000: 0.0213, 250000: 0.0377, 500000: 0.0732,
           750000: 0.0998, 1250000: 0.1564, 2500000: 0.3058,
           5000000: 0.6789}
LR_8GPU = {125000: 0.2642, 250000: 0.2748, 500000: 0.2638,
           750000: 0.2713, 1250000: 0.3046, 2500000: 0.3574,
           5000000: 0.4998, 10000000: 0.8703}


def _read(path):
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        return list(csv.DictReader(f))


def _style(ax, title, xlabel, ylabel):
    ax.set_facecolor(SURFACE)
    ax.figure.set_facecolor(SURFACE)
    ax.set_title(title, color=TEXT, fontsize=12, pad=12, loc="left")
    ax.set_xlabel(xlabel, color=TEXT2, fontsize=9)
    ax.set_ylabel(ylabel, color=TEXT2, fontsize=9)
    ax.grid(True, which="major", color=GRID, linewidth=0.6)
    ax.tick_params(colors=TEXT2, labelsize=8)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    for s in ("left", "bottom"):
        ax.spines[s].set_color(GRID)


def _series(ax, xs, ys, color, label):
    ax.plot(xs, ys, color=color, linewidth=2, marker="o", markersize=5,
            markerfacecolor=color, markeredgecolor=SURFACE,
            markeredgewidth=1, label=label)


def plot_bop(outdir):
    rows = _read("result_bop.csv")
    ours = {}
    for r in rows:  # keep the best (min) sweep per N
        n = int(r["N"])
        ours[n] = min(float(r["min_s"]), ours.get(n, float("inf")))
    # OOC device-mode rows extend ours past one chip's HBM (N >= 5M).
    ooc = {int(r["N"]): float(r["seconds"]) for r in _read(
        "result_ooc.csv")
        if r["op"] == "gram" and r["mode"] == "device"}
    fig, ax = plt.subplots(figsize=(6.4, 4.2), dpi=160)
    _style(ax, "x.T @ x  (N x 1000, fp32) — lower is better",
           "N (rows)", "seconds")
    ax.set_xscale("log")
    ax.set_yscale("log")
    for data, color, label in [
        (ours, C_OURS, "nums_tpu (1 device)"),
        (BOP_4GPU, C_4GPU, "reference, 4 GPU"),
        (BOP_8GPU, C_8GPU, "reference, 8 GPU"),
    ]:
        xs = sorted(data)
        _series(ax, xs, [data[x] for x in xs], color, label)
    if ooc:
        xs = sorted(ooc)
        ax.plot(xs, [ooc[x] for x in xs], color=C_OURS, linewidth=2,
                linestyle=(0, (4, 3)), marker="o", markersize=5,
                markerfacecolor=SURFACE, markeredgecolor=C_OURS,
                markeredgewidth=1.5,
                label="nums_tpu OOC stream (1 device)")
    ax.legend(frameon=False, fontsize=8, labelcolor=TEXT2)
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "bop.png"))
    plt.close(fig)


def plot_lr(outdir):
    rows = _read("result_lr.csv")
    ours = {}
    for r in rows:
        n = int(r["N"])
        ours[n] = min(float(r["min_s"]), ours.get(n, float("inf")))
    ooc = {int(r["N"]): float(r["seconds"]) for r in _read(
        "result_ooc.csv")
        if r["op"] == "lr" and r["mode"] == "device"}
    fig, ax = plt.subplots(figsize=(6.4, 4.2), dpi=160)
    _style(ax, "Logistic regression, one Newton step (N x 1000, fp32)",
           "N (rows)", "seconds")
    ax.set_xscale("log")
    ax.set_yscale("log")
    for data, color, label in [
        (ours, C_OURS, "nums_tpu (1 device)"),
        (LR_4GPU, C_4GPU, "reference, 4 GPU"),
        (LR_8GPU, C_8GPU, "reference, 8 GPU"),
    ]:
        xs = sorted(data)
        _series(ax, xs, [data[x] for x in xs], color, label)
    if ooc:
        xs = sorted(ooc)
        ax.plot(xs, [ooc[x] for x in xs], color=C_OURS, linewidth=2,
                linestyle=(0, (4, 3)), marker="o", markersize=5,
                markerfacecolor=SURFACE, markeredgecolor=C_OURS,
                markeredgewidth=1.5,
                label="nums_tpu OOC stream (1 device)")
    ax.legend(frameon=False, fontsize=8, labelcolor=TEXT2)
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "lr.png"))
    plt.close(fig)


def plot_tsqr(outdir):
    rows = [r for r in _read("result_tsqr.csv")
            if int(r["m"]) == 2**24 and int(r["n"]) == 128]
    if not rows:
        return
    names = {"indirect_tsr": "R only (indirect)",
             "direct_tsqr": "full Q, R (direct)"}
    labels = [names.get(r["op"], r["op"]) for r in rows]
    vals = [float(r["min_s"]) for r in rows]
    fig, ax = plt.subplots(figsize=(5.2, 3.4), dpi=160)
    _style(ax, "TSQR, 2^24 x 128 fp32 tall-skinny (1 device)",
           "", "seconds")
    bars = ax.bar(labels, vals, width=0.5, color=C_OURS, zorder=3)
    for b in bars:  # 4px-equivalent rounded data-end stand-in: flat bars
        ax.text(b.get_x() + b.get_width() / 2, b.get_height(),
                f" {b.get_height():.3f}s", ha="center", va="bottom",
                fontsize=8, color=TEXT2)
    ax.grid(axis="x", visible=False)
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "tsqr.png"))
    plt.close(fig)


def plot_gemm(outdir):
    rows = _read("result_gemm.csv")
    if not rows:
        return
    labels = [f"{int(r['n'])//1024}k x {int(r['n'])//1024}k {r['dtype']}"
              for r in rows]
    vals = [float(r["tflops"]) for r in rows]
    fig, ax = plt.subplots(figsize=(5.2, 3.4), dpi=160)
    _style(ax, "Square GEMM on one device", "", "TFLOP/s")
    ax.bar(labels, vals, width=0.5, color=C_OURS, zorder=3)
    for i, v in enumerate(vals):
        ax.text(i, v, f" {v:.1f}", ha="center", va="bottom",
                fontsize=8, color=TEXT2)
    ax.grid(axis="x", visible=False)
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "gemm.png"))
    plt.close(fig)


def plot_ooc(outdir):
    rows = [r for r in _read("result_ooc.csv") if r["mode"] == "device"]
    if not rows:
        return
    ops = {"gram": "gram (x.T @ x)", "lr": "Newton step"}
    fig, ax = plt.subplots(figsize=(6.4, 4.2), dpi=160)
    _style(ax, "Out-of-core per-pass vs the 8-GPU reference (device feed)",
           "N (rows)", "seconds")
    ax.set_xscale("log")
    series = {}
    for r in rows:
        series.setdefault(r["op"], {})[int(r["N"])] = float(r["seconds"])
    for (op, data), color in zip(sorted(series.items()),
                                 [C_OURS, "#eda100"]):  # slot 4 yellow
        xs = sorted(data)
        _series(ax, xs, [data[x] for x in xs], color,
                f"nums_tpu OOC {ops.get(op, op)}")
    ref_g = {k: v for k, v in BOP_8GPU.items() if k >= 5000000}
    ref_l = {k: v for k, v in LR_8GPU.items() if k >= 5000000}
    xs = sorted(ref_g)
    _series(ax, xs, [ref_g[x] for x in xs], C_8GPU, "8-GPU gram")
    xs = sorted(ref_l)
    ax.plot(xs, [ref_l[x] for x in xs], color=C_8GPU, linewidth=2,
            linestyle=(0, (4, 3)), marker="o", markersize=5,
            markerfacecolor=SURFACE, markeredgecolor=C_8GPU,
            markeredgewidth=1.5, label="8-GPU Newton step")
    ax.legend(frameon=False, fontsize=8, labelcolor=TEXT2)
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "ooc.png"))
    plt.close(fig)


C_BASE = "#8a8986"   # neutral baseline series (pure jax / plain XLA)


def plot_interleave(outdir):
    """Pure-jax vs BlockArray interleaved A/B (dispatch overhead):
    grouped bars per N from result_interleave.csv."""
    rows = [r for r in _read("result_interleave.csv")
            if r.get("mode") == "interleave"]
    if not rows:
        return
    med = {}  # N -> {path: median_s}, last row per key wins (newest)
    for r in rows:
        med.setdefault(int(r["N"]), {})[r["path"]] = float(r["median_s"])
    ns = [n for n in sorted(med)
          if {"pure_jax", "blockarray"} <= set(med[n])]
    if not ns:
        return
    xs = range(len(ns))
    fig, ax = plt.subplots(figsize=(6.4, 3.6), dpi=160)
    _style(ax, "Same-device interleaved A/B: raw jax.jit vs BlockArray "
               "dispatch", "N (rows, d=1000)", "seconds / execution")
    w, off = 0.36, 0.20
    ax.bar([x - off for x in xs], [med[n]["pure_jax"] for n in ns],
           width=w, color=C_BASE, label="pure jax.jit", zorder=3)
    ax.bar([x + off for x in xs], [med[n]["blockarray"] for n in ns],
           width=w, color=C_OURS, label="BlockArray path", zorder=3)
    for x, n in zip(xs, ns):
        ovh = med[n]["blockarray"] / med[n]["pure_jax"] - 1.0
        top = max(med[n]["pure_jax"], med[n]["blockarray"])
        ax.text(x, top, f" {ovh * 100:+.1f}%", ha="center", va="bottom",
                fontsize=8, color=TEXT2)
    ax.set_xticks(list(xs))
    ax.set_xticklabels([f"{n // 1000}k" if n < 10**6
                        else f"{n / 1e6:g}M" for n in ns])
    ax.grid(axis="x", visible=False)
    ax.legend(frameon=False, fontsize=8, labelcolor=TEXT2)
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "interleave.png"))
    plt.close(fig)


def plot_device_resident(outdir):
    """In-program fori_loop gram per route (device-resident throughput)
    from result_device_resident.csv."""
    rows = [r for r in _read("result_device_resident.csv")
            if r.get("mode") == "device_resident"]
    if not rows:
        return
    med = {}  # N -> {route: per_iter_s}, newest row per key wins
    for r in rows:
        med.setdefault(int(r["N"]), {})[r["route"]] = float(r["per_iter_s"])
    ns = sorted(med)
    xs = range(len(ns))
    fig, ax = plt.subplots(figsize=(6.4, 3.6), dpi=160)
    _style(ax, "Device-resident gram (in-program loop, fixed costs "
               "cancelled)", "N (rows)", "ms / iteration")
    vals = [med[n].get("xla", 0.0) * 1e3 for n in ns]
    ax.bar(list(xs), vals, width=0.5, color=C_OURS,
           label="XLA dot_general", zorder=3)
    for x, v in zip(xs, vals):
        if v:
            ax.text(x, v, f" {v:.2f}", ha="center", va="bottom",
                    fontsize=8, color=TEXT2)
    ax.set_xticks(list(xs))
    ax.set_xticklabels([f"{n // 1000}k" if n < 10**6
                        else f"{n / 1e6:g}M" for n in ns])
    ax.grid(axis="x", visible=False)
    ax.legend(frameon=False, fontsize=8, labelcolor=TEXT2)
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "device_resident.png"))
    plt.close(fig)


def plot_models(outdir):
    rows = _read("result_models.csv")
    if not rows:
        return
    best = {}
    for r in rows:  # best (min) run per (model, op)
        key = (r["model"], r["op"], int(r["n"]), int(r["d"]))
        best[key] = min(float(r["seconds"]),
                        best.get(key, float("inf")))
    labels = [f"{m} {op}\n{n // 1_000_000}M x {d}" if n >= 10**6
              else f"{m} {op}\n{n // 1000}k x {d}"
              for (m, op, n, d) in best]
    vals = list(best.values())
    fig, ax = plt.subplots(figsize=(6.4, 3.6), dpi=160)
    _style(ax, "Beyond-reference models (1 device) — the reference "
               "has no trees model and single-node SVD only",
           "", "seconds")
    ax.bar(labels, vals, width=0.55, color=C_OURS, zorder=3)
    for i, v in enumerate(vals):
        ax.text(i, v, f" {v:.2f}s", ha="center", va="bottom",
                fontsize=8, color=TEXT2)
    ax.grid(axis="x", visible=False)
    fig.tight_layout()
    fig.savefig(os.path.join(outdir, "models.png"))
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="plots")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    plot_bop(args.out)
    plot_lr(args.out)
    plot_tsqr(args.out)
    plot_gemm(args.out)
    plot_ooc(args.out)
    plot_models(args.out)
    plot_interleave(args.out)
    plot_device_resident(args.out)
    made = sorted(os.listdir(args.out))
    print(f"wrote {len(made)} figures to {args.out}/: {', '.join(made)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
