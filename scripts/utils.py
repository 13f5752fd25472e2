"""Benchmark harness (parity: reference scripts/utils.py benchmark_func —
warmup + repeat + CSV row emission)."""

import time

import numpy as np


def benchmark_ready(run, warmup=1, repeat=5, with_median=False):
    """Time ``run()`` ``repeat`` times after ``warmup`` calls, each call
    ending in ``jax.block_until_ready``; returns (min_s, mean_s, std_s
    [, median_s]) per call.

    With lazy batching on (the default), ``run`` must force dispatch
    (e.g. return ``BlockArray.raw``) — a bare BlockArray op only builds
    a deferred DAG node and no device work starts.
    """
    import jax

    for _ in range(warmup):
        jax.block_until_ready(run())
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        times.append(time.perf_counter() - t0)
    arr = np.array(times)
    out = (float(arr.min()), float(arr.mean()), float(arr.std()))
    if with_median:
        out += (float(np.median(arr)),)
    return out


def append_csv(path, row: dict):
    """Append one row; if the row introduces columns the existing file
    lacks (schema evolved between rounds), rewrite the file under the
    union header (old rows get "" in the new columns) instead of
    silently misaligning values against the old header."""
    import csv
    import os

    exists = os.path.isfile(path)
    if exists:
        with open(path, newline="") as f:
            reader = csv.DictReader(f)
            old_fields = reader.fieldnames or []
            if set(row.keys()) - set(old_fields):
                fields = list(old_fields) + [
                    k for k in row.keys() if k not in old_fields
                ]
                rows = list(reader)
                with open(path, "w", newline="") as g:
                    w = csv.DictWriter(g, fieldnames=fields,
                                       restval="")
                    w.writeheader()
                    w.writerows(rows)
                    w.writerow(row)
                return
            fields = old_fields
    else:
        fields = list(row.keys())
    with open(path, "a", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval="")
        if not exists:
            w.writeheader()
        w.writerow(row)
