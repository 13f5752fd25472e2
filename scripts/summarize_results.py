"""Render benchmark CSVs against the reference baselines as tables
(role of the reference's scripts/plot_all.py, in table form).

Usage: python scripts/summarize_results.py [--dir .]
"""

import argparse
import csv
import os
import sys

# Reference baselines (BASELINE.md): best config per N, seconds.
BOP_BASELINE = {
    125000: ("4xGPU", 0.0065), 250000: ("4xGPU", 0.0113),
    1250000: ("8xGPU", 0.0480), 2500000: ("8xGPU", 0.0714),
    5000000: ("8xGPU", 0.1099), 10000000: ("8xGPU", 0.2640),
    20000000: ("8xGPU", 0.5349),
}
LR_BASELINE = {
    125000: ("4xGPU", 0.0213), 250000: ("4xGPU", 0.0377),
    500000: ("4xGPU", 0.0732), 750000: ("4xGPU", 0.0998),
    1250000: ("4xGPU", 0.1564), 2500000: ("4xGPU", 0.3058),
    5000000: ("8xGPU", 0.4998), 10000000: ("8xGPU", 0.8703),
}


def read_csv(path):
    if not os.path.isfile(path):
        return []
    with open(path) as f:
        return list(csv.DictReader(f))


def table(rows, baseline_map, key="N"):
    lines = [
        "| N | ours (s) | best baseline (s) | speedup |",
        "|---|---|---|---|",
    ]
    for row in rows:
        n = int(row[key])
        t = float(row["min_s"])
        if t < 0:
            lines.append(f"| {n:,} | OOM | - | - |")
            continue
        base = baseline_map.get(n)
        if base:
            name, bt = base
            lines.append(
                f"| {n:,} | {t:.4f} | {bt:.4f} ({name}) | {bt / t:.2f}x |"
            )
        else:
            lines.append(f"| {n:,} | {t:.4f} | - | - |")
    return "\n".join(lines)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dir", default=".")
    args = parser.parse_args(argv)
    d = args.dir

    bop = read_csv(os.path.join(d, "result_bop.csv"))
    if bop:
        print("## x.T @ x (N x 1000 fp32)\n")
        print(table(bop, BOP_BASELINE))
        print()
    lr = read_csv(os.path.join(d, "result_lr.csv"))
    if lr:
        print("## Logistic regression Newton step (N x 1000 fp32)\n")
        print(table(lr, LR_BASELINE))
        print()
    tsqr = read_csv(os.path.join(d, "result_tsqr.csv"))
    if tsqr:
        print("## TSQR\n")
        for row in tsqr:
            print(f"- {row['op']} {row['m']}x{row['n']}: {row['min_s']}s")
        print()
    gemm = read_csv(os.path.join(d, "result_gemm.csv"))
    if gemm:
        print("## Square GEMM\n")
        for row in gemm:
            print(f"- {row['n']}^2 {row['dtype']}: {row['min_s']}s "
                  f"({row['tflops']} TFLOP/s)")
        print()
    ooc = read_csv(os.path.join(d, "result_ooc.csv"))
    if ooc:
        base = {"gram": BOP_BASELINE, "lr": LR_BASELINE}
        print("## Out-of-core rows\n")
        for row in ooc:
            n, t = int(row["N"]), float(row["seconds"])
            ref = base.get(row["op"], {}).get(n)
            vs = f" ({ref[1] / t:.2f}x vs {ref[0]} {ref[1]}s)" if ref else ""
            print(f"- {row['op']} N={n:,} [{row['mode']}]: {t}s{vs} "
                  f"— {row['note']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
