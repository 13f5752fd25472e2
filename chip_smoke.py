"""GPU tier: drive nums_tpu's main path once on the card, at the
reference's own problem sizes, and check every result.

    python chip_smoke.py            # one GPU: device, gram, newton, tsqr,
                                    # ooc and surface phases
    python chip_smoke.py --cards 4  # four GPUs: the mesh backend only

Everything goes through the user entry points (``nums_tpu.init()``,
BlockArrays, ``nums_tpu.numpy``, ``nums_tpu.models``). Every check prints
one JSON line: its phase, ``ok``, the max error scaled by max|reference|,
the tolerance and the matmul precision, and, where the check is timed,
the warm time (``block_until_ready``) and the compile time (first call
minus warm call). Each phase then prints a summary line with
``peak_bytes_in_use`` (the process-wide peak so far). The first line
names the card; the last line is exactly
``{"ok": ..., "device": {"platform": ..., "kind": ..., "count": ...}}``.

There is no fallback: on any platform but ``gpu`` the run stops after
the device phase with ``"ok": false`` and a non-zero exit, and a phase
that raises or misses a tolerance fails the run.

Data is generated on the device from a closed counter-hash formula
(``formula``), so the host can recompute any entry in float64 without
moving the matrix. Magnitudes are 1 + k/1024 plus 0.49 of a TF32 ulp, so
TF32 rounding lowers every operand by about 4e-4 in the same direction:
a silent TF32 contraction shows up as a systematic error far above the
HIGHEST tolerance instead of averaging out over millions of rows.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, ".smoke_work")  # OOC spill target; removed

# Scaled-error tolerances, max|ours - ref| / max|ref|:
# TF32 keeps a 10-bit mantissa, so each operand is off by up to 2^-11
# relative and a product by twice that; on top, the tensor cores'
# fp32 accumulation truncates, and over the 2.5M-row contraction that
# bias dominates: an H100 (700 W) measured 5.5e-3 on the formula's
# gram. 1e-2 passes that with room; wrong math is off by O(1).
TOL_TF32 = 1e-2
# Full fp32 products; the error left is fp32 accumulation over up to
# 2.5M rows: an H100 (700 W) measured 8.2e-5 on the formula's gram.
# A TF32 run of the same data misses this by more than 25x.
TOL_HIGHEST = 2e-4
# A Newton iterate at TF32 against one at HIGHEST: the TF32 bias in H
# and g (above) passes through a solve with cond(H) near 1.
TOL_NEWTON_TF32 = 2e-2

# Published dense peaks, NVIDIA H100 SXM data sheet (700 W), keyed by
# jax's device_kind. A card not listed gets no roofline share.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "tf32_flops": 495e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12,
    },
}

# Problem sizes. gram/newton: the reference's two benchmarks (d = 1000
# fp32 at its 2.5M-row point); tsqr: the 2^24 x 128 TSQR target; ooc: a
# 4 GB spill; mesh: 10 GB per card on four cards.
FULL = {
    "gram": (2_500_000, 1000),
    "newton": (2_500_000, 1000),
    "newton_iters": 3,
    "tsqr": (2 ** 24, 128),
    "ooc": (1_000_000, 1000),
    "ooc_panel_rows": 125_000,
    "mesh": (10_000_000, 1000),
    "mesh_ragged": (1_000_003, 1000),
    "mesh_gemm": 32_768,
    "ref_chunk_rows": 500_000,
}


# ----------------------------------------------------------------------
# Output
# ----------------------------------------------------------------------


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    """Card name and power limit, read by a child process (no JAX)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {type(e).__name__}"
    return out.stdout.strip() or f"nvidia-smi rc={out.returncode}"


def device_info():
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def scaled_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return float("inf")
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    return float(np.max(np.abs(got - want))) / max(scale, 1e-30)


def result(phase, name, err, tol, precision, **extra):
    """One check: ``ok`` iff ``err <= tol`` (NaN/inf fail)."""
    rec = {"phase": phase, "check": name, "ok": bool(err <= tol),
           "err": err, "tol": tol, "precision": precision}
    rec.update(extra)
    emit(rec)
    return rec


def check(phase, name, got, want, tol, precision, **extra):
    return result(phase, name, scaled_err(got, want), tol, precision,
                  **extra)


def flag(phase, name, ok, **extra):
    rec = {"phase": phase, "check": name, "ok": bool(ok)}
    rec.update(extra)
    emit(rec)
    return rec


def timed(fn, reps=3):
    """(value, first_s, warm_s): ``fn`` returns device arrays; each call
    ends in ``block_until_ready``. warm_s is the median of ``reps``."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        out = None  # free the last result before the next call
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return out, first, statistics.median(warm)


def timing(first, warm):
    return {"warm_s": warm, "compile_s": max(0.0, first - warm)}


def roofline(kind, flops, nbytes, seconds, peak_key):
    """Least time the card could take (larger of flops/peak and
    bytes/bandwidth) over the measured time, with the bound named."""
    peaks = PEAKS.get(kind)
    if peaks is None or not seconds:
        return {"roofline_share": None, "bound": None,
                "peak": f"{kind!r} not in PEAKS"}
    t_flop = flops / peaks[peak_key]
    t_mem = nbytes / peaks["hbm_bytes"]
    return {
        "roofline_share": max(t_flop, t_mem) / seconds,
        "bound": "compute" if t_flop >= t_mem else "memory",
        "tflops": flops / seconds / 1e12,
        "peak": f"{peak_key} {peaks[peak_key] / 1e12:g} TFLOP/s, "
                f"HBM {peaks['hbm_bytes'] / 1e12:g} TB/s",
    }


# ----------------------------------------------------------------------
# Data: one closed formula, evaluated on the device or on the host
# ----------------------------------------------------------------------


def _mix(xp, h):
    h = h ^ (h >> 16)
    h = h * xp.uint32(0x7FEB352D)
    h = h ^ (h >> 15)
    h = h * xp.uint32(0x846CA68B)
    return h ^ (h >> 16)


def formula(xp, i, j, seed=0):
    """X[i, j] in float32 for uint32 index arrays (numpy or jax.numpy):
    sign * (1 + k/1024 + 63/2^17), k and the sign from a counter hash."""
    h = _mix(xp, i * xp.uint32(0x9E3779B1) + j * xp.uint32(0x85EBCA77)
             + xp.uint32((seed * 0x27D4EB2F + 1) & 0xFFFFFFFF))
    k = ((h >> 8) & xp.uint32(255)).astype(xp.float32)
    mag = 1.0 + k * (2.0 ** -10) + 63.0 * (2.0 ** -17)
    sign = 1.0 - 2.0 * (h & xp.uint32(1)).astype(xp.float32)
    return (sign * mag).astype(xp.float32)


def uniform(xp, i, seed):
    """A uniform [0, 1) float32 per row index (for labels)."""
    h = _mix(xp, i * xp.uint32(0x9E3779B1)
             + xp.uint32((seed * 0x165667B1) & 0xFFFFFFFF))
    return (h >> 8).astype(xp.float32) * (2.0 ** -24)


def labels(xp, X, i, beta_true, seed):
    """Bernoulli(sigmoid(X beta_true)) labels from a hashed uniform."""
    eta = X @ beta_true
    p = 1.0 / (1.0 + xp.exp(-eta))
    return (uniform(xp, i, seed) < p).astype(xp.float32)


def beta_true(d):
    """Coefficients that make eta ~ N(0, 1): not separable."""
    j = np.arange(d, dtype=np.uint32)
    return (0.03 * formula(np, j, np.zeros(1, np.uint32), seed=7)
            ).astype(np.float32)


def gen_matrix(shape, seed=0, sharding=None):
    """(n, d) float32 from ``formula``, built on the device."""
    import jax
    import jax.numpy as jnp

    n, d = shape

    def gen():
        i = jax.lax.broadcasted_iota(jnp.uint32, (n, d), 0)
        j = jax.lax.broadcasted_iota(jnp.uint32, (n, d), 1)
        return formula(jnp, i, j, seed)

    return jax.jit(gen, out_shardings=sharding)()


def gen_labels(X, sharding=None, seed=11):
    import jax
    import jax.numpy as jnp

    bt = jnp.asarray(beta_true(X.shape[1]))

    def gen(X):
        i = jnp.arange(X.shape[0], dtype=jnp.uint32)
        return labels(jnp, X, i, bt, seed)

    with jax.default_matmul_precision("highest"):
        return jax.jit(gen, out_shardings=sharding)(X)


def host_columns(n, cols, seed=0):
    """Columns of ``formula`` in float64 on the host."""
    i = np.arange(n, dtype=np.uint32)
    return {c: formula(np, i, np.full(1, c, np.uint32), seed)
            .astype(np.float64) for c in cols}


def as_blockarray(app, data, block_rows):
    from nums_tpu.core.array.blockarray import BlockArray
    from nums_tpu.core.grid import ArrayGrid

    shape = tuple(data.shape)
    bs = (min(block_rows, shape[0]),) + shape[1:]
    return BlockArray(data, ArrayGrid(shape, bs, data.dtype.name),
                      app.backend)


# ----------------------------------------------------------------------
# Plain references (jax.numpy only, no nums_tpu code)
# ----------------------------------------------------------------------


def plain_gram(precision=None):
    import jax
    import jax.numpy as jnp

    return jax.jit(lambda x: jnp.matmul(x.T, x, precision=precision))


def plain_newton_stats(X, y, b, precision=None):
    """Logistic (g, H) at beta ``b`` for the intercept-augmented design
    [X, 1], without materializing [X, 1]."""
    import jax
    import jax.numpy as jnp

    eta = jnp.matmul(X, b[:-1], precision=precision) + b[-1]
    mu = jax.nn.sigmoid(eta)
    r = mu - y
    s = mu * (1.0 - mu)
    gx = jnp.matmul(X.T, r, precision=precision)
    Xs = X * s[:, None]
    Hxx = jnp.matmul(Xs.T, X, precision=precision)
    hx1 = jnp.sum(Xs, axis=0)
    g = jnp.concatenate([gx, jnp.sum(r)[None]])
    H = jnp.block([[Hxx, hx1[:, None]],
                   [hx1[None, :], jnp.sum(s)[None, None]]])
    return g, H


def plain_newton(X, y, iters, precision=None):
    """``iters`` undamped Newton steps from zero, plain jnp."""
    import jax
    import jax.numpy as jnp

    def run(X, y):
        def step(_, b):
            g, H = plain_newton_stats(X, y, b, precision)
            return b - jnp.linalg.solve(H, g)

        b0 = jnp.zeros((X.shape[1] + 1,), X.dtype)
        return jax.lax.fori_loop(0, iters, step, b0)

    return jax.jit(run)(X, y)


def chunked_reference(n, d, chunk, precision, iters=0, seed=0,
                      label_seed=11):
    """Gram (iters == 0) or ``iters`` Newton steps over the ``formula``
    matrix of n rows on ONE device, regenerating row chunks so the full
    matrix never has to fit: the single-card answer for a problem that
    is only held whole across the mesh."""
    import jax
    import jax.numpy as jnp

    nchunks = -(-n // chunk)
    bt = jnp.asarray(beta_true(d))

    def rows(k):
        i = (jnp.uint32(k * chunk)
             + jax.lax.broadcasted_iota(jnp.uint32, (chunk, d), 0))
        j = jax.lax.broadcasted_iota(jnp.uint32, (chunk, d), 1)
        valid = (i[:, 0] < jnp.uint32(n)).astype(jnp.float32)
        X = formula(jnp, i, j, seed) * valid[:, None]
        return X, i[:, 0], valid

    if iters == 0:
        def body(k, G):
            X, _, _ = rows(k)
            return G + jnp.matmul(X.T, X, precision=precision)

        return jax.jit(lambda: jax.lax.fori_loop(
            0, nchunks, body, jnp.zeros((d, d), jnp.float32)))()

    def stats(b):
        def body(k, gh):
            g, H = gh
            X, i, valid = rows(k)
            y = labels(jnp, X, i, bt, label_seed)
            eta = jnp.matmul(X, b[:-1], precision=precision) + b[-1]
            mu = jax.nn.sigmoid(eta)
            r = (mu - y) * valid
            s = mu * (1.0 - mu) * valid
            Xs = X * s[:, None]
            hx1 = jnp.sum(Xs, axis=0)
            dg = jnp.concatenate([jnp.matmul(X.T, r, precision=precision),
                                  jnp.sum(r)[None]])
            dH = jnp.block([
                [jnp.matmul(Xs.T, X, precision=precision), hx1[:, None]],
                [hx1[None, :], jnp.sum(s)[None, None]],
            ])
            return g + dg, H + dH

        zero = (jnp.zeros((d + 1,), jnp.float32),
                jnp.zeros((d + 1, d + 1), jnp.float32))
        return jax.lax.fori_loop(0, nchunks, body, zero)

    def newton(_, b):
        g, H = stats(b)
        return b - jnp.linalg.solve(H, g)

    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda: jax.lax.fori_loop(
            0, iters, newton, jnp.zeros((d + 1,), jnp.float32)))()


# ----------------------------------------------------------------------
# Phases. Each returns a list of check records.
# ----------------------------------------------------------------------


def phase_device(_app, _cfg, _workdir, want_cards=1):
    info = device_info()
    return [flag("device", "platform is gpu", info["platform"] == "gpu",
                 **info),
            flag("device", f"at least {want_cards} card(s)",
                 info["count"] >= want_cards, count=info["count"])]


def phase_gram(app, cfg, _workdir):
    """Reference benchmark 1: x.T @ x at 2.5M x 1000 fp32 (10 GB),
    through the BlockArray at DEFAULT and HIGHEST, against a plain
    jax.jit HIGHEST dot and float64 host entries."""
    import jax

    n, d = cfg["gram"]
    kind = device_info()["kind"]
    X = as_blockarray(app, gen_matrix((n, d)), max(1, n // 10))
    out = []
    hi = jax.lax.Precision.HIGHEST
    plain_hi = plain_gram(hi)
    ref, f_ref, w_ref = timed(lambda: plain_hi(X.data))
    ref = np.asarray(ref)
    plain_def = plain_gram(None)
    _, f_pd, w_pd = timed(lambda: plain_def(X.data))
    flops, nbytes = 2.0 * n * d * d, 4.0 * n * d + 4.0 * d * d

    G_def, f_def, w_def = timed(lambda: (X.T @ X).raw)
    G_def = np.asarray(G_def)[:d, :d]
    with jax.default_matmul_precision("highest"):
        G_hi, f_hi, w_hi = timed(lambda: (X.T @ X).raw)
    G_hi = np.asarray(G_hi)[:d, :d]

    cols = sorted({0, 1, d // 2, d - 1})
    host = host_columns(n, cols)
    pairs = [(a, b) for a in cols for b in cols if a <= b]
    f64 = np.array([host[a] @ host[b] for a, b in pairs])

    def entries(G):
        return np.array([G[a, b] for a, b in pairs])

    err_tf32_f64 = scaled_err(entries(G_def), f64)
    out.append(result(
        "gram", "blockarray gram vs float64 entries", err_tf32_f64,
        TOL_TF32, "default", **timing(f_def, w_def),
        **roofline(kind, flops, nbytes, w_def, "tf32_flops"),
    ))
    out.append(result(
        "gram", "blockarray gram vs jit HIGHEST", scaled_err(G_def, ref),
        TOL_TF32, "default",
    ))
    out.append(result(
        "gram", "blockarray gram HIGHEST vs float64 entries",
        scaled_err(entries(G_hi), f64), TOL_HIGHEST, "highest",
        default_precision_err=err_tf32_f64,
        default_would_pass_highest_tol=bool(err_tf32_f64 <= TOL_HIGHEST),
        **timing(f_hi, w_hi),
        **roofline(kind, flops, nbytes, w_hi, "f32_flops"),
    ))
    out.append(result(
        "gram", "blockarray gram HIGHEST vs jit HIGHEST",
        scaled_err(G_hi, ref), TOL_HIGHEST, "highest",
    ))
    out.append(result(
        "gram", "plain jit HIGHEST vs float64 entries",
        scaled_err(entries(ref), f64), TOL_HIGHEST, "highest",
        **timing(f_ref, w_ref),
        **roofline(kind, flops, nbytes, w_ref, "f32_flops"),
    ))
    out.append(flag(
        "gram", "plain jit x.T @ x (the XLA bar)", True, precision="default",
        **timing(f_pd, w_pd),
        **roofline(kind, flops, nbytes, w_pd, "tf32_flops"),
    ))
    return out


def _fit(X, y, iters, fuse, precision=None):
    """LogisticRegression(solver="newton") through the fused or eager
    path; returns (beta with intercept last, model)."""
    import jax

    from nums_tpu.core import settings
    from nums_tpu.models.glms import LogisticRegression

    prev = settings.glm_fuse
    settings.glm_fuse = "1" if fuse else "0"
    try:
        model = LogisticRegression(solver="newton", tol=0.0,
                                   max_iter=iters)
        if precision is None:
            model.fit(X, y)
        else:
            with jax.default_matmul_precision(precision):
                model.fit(X, y)
    finally:
        settings.glm_fuse = prev
    beta = np.concatenate([model._beta.get(),
                           np.atleast_1d(model._beta0.get())])
    return beta, model


def phase_newton(app, cfg, _workdir):
    """Reference benchmark 2: Newton logistic regression at 2.5M x 1000."""
    import jax
    import jax.numpy as jnp

    from nums_tpu.models import fast_glm

    n, d = cfg["newton"]
    iters = cfg["newton_iters"]
    kind = device_info()["kind"]
    hi = jax.lax.Precision.HIGHEST
    Xd = gen_matrix((n, d))
    yd = gen_labels(Xd)
    rows = max(1, n // 10)
    X = as_blockarray(app, Xd, rows)
    y = as_blockarray(app, yd, rows)
    out = []

    ref_k = np.asarray(plain_newton(Xd, yd, iters, hi))
    ref_1 = np.asarray(plain_newton(Xd, yd, 1, hi))
    scale_note = {"ref_max_abs_beta": float(np.max(np.abs(ref_k)))}

    t0 = time.perf_counter()
    beta, _ = _fit(X, y, iters, fuse=True)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    beta, _ = _fit(X, y, iters, fuse=True)
    warm = time.perf_counter() - t0
    out.append(check(
        "newton", f"fused fit ({iters} iters) vs plain HIGHEST", beta,
        ref_k, TOL_NEWTON_TF32, "default", **timing(first, warm),
        per_iter_s=warm / iters, **scale_note,
    ))
    beta_hi, _ = _fit(X, y, iters, fuse=True, precision="highest")
    out.append(check(
        "newton", f"fused fit HIGHEST ({iters} iters) vs plain HIGHEST",
        beta_hi, ref_k, TOL_HIGHEST, "highest",
    ))

    t0 = time.perf_counter()
    beta1, _ = _fit(X, y, 1, fuse=False)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    beta1, _ = _fit(X, y, 1, fuse=False)
    warm = time.perf_counter() - t0
    out.append(check(
        "newton", "eager step (glm_fuse=0) vs plain HIGHEST", beta1,
        ref_1, TOL_NEWTON_TF32, "default", **timing(first, warm),
    ))

    # One step's statistics, library (intercept-augmented design) vs
    # plain, halfway to the fitted beta (at the optimum g cancels to ~0).
    b = jnp.asarray(0.5 * ref_k)
    g_ref, H_ref = jax.jit(
        lambda X, y, b: plain_newton_stats(X, y, b, hi))(Xd, yd, b)
    Xa = jnp.concatenate([Xd, jnp.ones((n, 1), Xd.dtype)], axis=1)
    lib_stats = jax.jit(
        lambda X, y, b: fast_glm._newton_stats("logistic", X, y, b))
    (g, H) = lib_stats(Xa, yd, b)
    del Xa
    out.append(check("newton", "library g vs plain HIGHEST", g, g_ref,
                     TOL_TF32, "default"))
    out.append(check("newton", "library H vs plain HIGHEST", H, H_ref,
                     TOL_TF32, "default"))

    # The XLA bar for one Newton-statistics pass (eta, g, H), default
    # precision; the least traffic is one read of X.
    stats_def = jax.jit(lambda X, y, b: plain_newton_stats(X, y, b))
    _, f_s, w_s = timed(lambda: stats_def(Xd, yd, b))
    flops = 2.0 * n * d * d + 4.0 * n * d
    out.append(flag(
        "newton", "plain jit Newton statistics (the XLA bar)", True,
        precision="default", **timing(f_s, w_s),
        **roofline(kind, flops, 4.0 * n * d, w_s, "tf32_flops"),
    ))
    return out


def _orth_err(Q):
    """max|QᵀQ - I| with 4096-row chunk grams summed pairwise, so the
    check's own fp32 accumulation stays far below the tolerance."""
    import jax
    import jax.numpy as jnp

    def f(Q):
        m, n = Q.shape
        c = m // 4096
        head = Q[: c * 4096].reshape(c, 4096, n)
        G = jnp.einsum("cij,cik->jk", head, head,
                       precision=jax.lax.Precision.HIGHEST)
        tail = Q[c * 4096:]
        G = G + jnp.matmul(tail.T, tail, precision=jax.lax.Precision.HIGHEST)
        return jnp.max(jnp.abs(G - jnp.eye(n, dtype=G.dtype)))

    return float(jax.jit(f)(Q))


def _recon_err(Q, R, X):
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda q, r, x: jnp.max(jnp.abs(
        jnp.matmul(q, r, precision=jax.lax.Precision.HIGHEST) - x))
        / jnp.max(jnp.abs(x)))
    return float(f(Q, R, X))


def phase_tsqr(app, cfg, _workdir):
    """direct_tsqr / indirect_tsr / qr at 2^24 x 128 fp32 (8.6 GB)."""
    import jax

    from nums_tpu.core import settings

    m, n = cfg["tsqr"]
    X = as_blockarray(app, gen_matrix((m, n), seed=3), max(1, m // 16))
    out = []
    route = "cholqr2" if app._use_cholqr(X) else "householder"
    out.append(flag("tsqr", "auto route is CholeskyQR2 off the CPU",
                    route == "cholqr2" or device_info()["platform"] == "cpu",
                    route=route))

    QR, first, warm = timed(lambda: tuple(a.raw for a in app.direct_tsqr(X)),
                            reps=2)
    Q, R = QR
    out.append(result("tsqr", "direct_tsqr orthogonality", _orth_err(Q),
                      TOL_HIGHEST, "highest", route=route,
                      **timing(first, warm)))
    out.append(result("tsqr", "direct_tsqr reconstruction",
                      _recon_err(Q, R, X.data), TOL_HIGHEST, "highest"))
    del Q, QR
    R_dir = np.abs(np.asarray(R))

    R_ind, first, warm = timed(lambda: app.indirect_tsr(X).raw, reps=2)
    out.append(check("tsqr", "indirect_tsr |R| vs direct |R|",
                     np.abs(np.asarray(R_ind)), R_dir, TOL_HIGHEST,
                     "highest", **timing(first, warm)))

    Qb, Rb = app.qr(X)
    # qr's Q = X R^-1 is a default-precision product.
    out.append(result("tsqr", "qr orthogonality", _orth_err(Qb.raw),
                      TOL_TF32, "default"))
    del Qb, Rb

    prev = settings.tsqr_method
    settings.tsqr_method = "householder"
    try:
        t0 = time.perf_counter()
        Qh, Rh = app.direct_tsqr(X)
        Qh_raw = jax.block_until_ready(Qh.raw)
        seconds = time.perf_counter() - t0
        out.append(result("tsqr", "householder direct_tsqr orthogonality",
                          _orth_err(Qh_raw), TOL_HIGHEST, "highest",
                          first_call_s=seconds))
        del Qh, Rh, Qh_raw
    finally:
        settings.tsqr_method = prev
    return out


def phase_ooc(app, cfg, workdir):
    """spill >= 1M x 1000 fp32 (4 GB) to local disk, then gram_ooc and
    a streamed logistic fit against the in-core results."""
    import jax

    n, d = cfg["ooc"]
    iters = cfg["newton_iters"]
    out = []
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "ooc_X")
    Xd = gen_matrix((n, d), seed=5)
    yd = gen_labels(Xd, seed=13)
    X = as_blockarray(app, Xd, cfg["ooc_panel_rows"])
    y = as_blockarray(app, yd, cfg["ooc_panel_rows"])
    t0 = time.perf_counter()
    dX = app.spill(X, path)
    spill_s = time.perf_counter() - t0

    G_in = np.asarray((X.T @ X).get())
    G, first, warm = timed(lambda: app.gram_ooc(dX).raw, reps=2)
    # Both at TF32, but with different contraction depths (125k-row
    # panels against one 1M-row dot), so the accumulation bias differs.
    out.append(check("ooc", "gram_ooc vs in-core gram", G, G_in,
                     TOL_TF32, "default", spill_s=spill_s,
                     feed_gb_per_s=4.0 * n * d / warm / 1e9,
                     **timing(first, warm)))

    beta_in, _ = _fit(X, y, iters, fuse=True)
    y_host = np.asarray(yd)
    from nums_tpu.models.glms import LogisticRegression

    t0 = time.perf_counter()
    model = LogisticRegression(solver="newton", tol=0.0, max_iter=iters)
    model.fit(dX, y_host)
    fit_s = time.perf_counter() - t0
    beta = np.concatenate([model._beta.get(),
                           np.atleast_1d(model._beta0.get())])
    out.append(check("ooc", f"streamed logistic fit ({iters} iters) vs "
                     "in-core fit", beta, beta_in, TOL_NEWTON_TF32, "default",
                     first_call_s=fit_s))

    # Donation: the streamed fold donates its accumulator, so a full
    # re-run must not grow device memory. memory_stats must exist.
    stats = jax.devices()[0].memory_stats()
    if stats is None or "bytes_in_use" not in stats:
        out.append(flag("ooc", "memory_stats available", False))
    else:
        app.gram_ooc(dX).get()
        before = jax.devices()[0].memory_stats()["bytes_in_use"]
        app.gram_ooc(dX).get()
        growth = jax.devices()[0].memory_stats()["bytes_in_use"] - before
        out.append(flag("ooc", "donation: no growth on re-run",
                        growth < 16 * 1024 * 1024, growth_bytes=growth))
    del X, Xd, dX
    shutil.rmtree(workdir, ignore_errors=True)
    return out


def phase_surface(app, cfg, workdir):
    """The rest of the op vocabulary at small sizes."""
    import jax
    import jax.numpy as jnp

    import nums_tpu.numpy as nps
    from nums_tpu import autodiff
    from nums_tpu.core.io.datasets import BimodalGaussian
    from nums_tpu.core.ops import summa
    from nums_tpu.models.glms import LinearRegression, LogisticRegression

    p = "surface"
    rs = np.random.RandomState(0)
    out = []
    x = rs.randn(4096, 256).astype(np.float32)
    w = rs.randn(256, 128).astype(np.float32)
    bx = app.array(x, block_shape=(1024, 256))
    bw = app.array(w, block_shape=(256, 128))
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    out.append(check(p, "matmul", (bx @ bw).get(), x64 @ w64, TOL_TF32,
                     "default"))
    hi = jax.jit(lambda a, b: jnp.matmul(
        a, b, precision=jax.lax.Precision.HIGHEST))
    out.append(check(p, "matmul HIGHEST", hi(bx.data, bw.data), x64 @ w64,
                     1e-5, "highest"))
    out.append(check(p, "elementwise chain", (nps.exp(bx * 0.01) + 1).get(),
                     np.exp(x64 * 0.01) + 1, 1e-5, "n/a"))
    out.append(check(p, "sum axis 0", bx.sum(axis=0).get(), x64.sum(axis=0),
                     1e-5, "n/a"))
    out.append(check(p, "std", float(app.std(bx)), x64.std(), 1e-5, "n/a"))

    u, s, vt = app.svd(bx)
    out.append(check(p, "svd singular values", np.sort(s.get()),
                     np.sort(np.linalg.svd(x64, compute_uv=False)), 1e-3,
                     "highest"))
    spd = (x64.T @ x64 + 256 * np.eye(256)).astype(np.float32)
    bspd = app.array(spd, block_shape=(256, 256))
    out.append(check(p, "cholesky", app.cholesky(bspd).get(),
                     np.linalg.cholesky(spd.astype(np.float64)), 1e-4,
                     "n/a"))

    real_X, real_y = BimodalGaussian.get_dataset(5000, 10)
    Xg = app.array(real_X.astype(np.float32), block_shape=(1250, 10))
    yg = app.array(real_y.astype(np.float32), block_shape=(1250,))
    model = LogisticRegression(solver="newton", tol=1e-6, max_iter=10)
    model.fit(Xg, yg)
    acc = float(np.mean(model.predict(Xg).get() == real_y))
    out.append(flag(p, "GLM newton accuracy > 0.95", acc > 0.95,
                    accuracy=acc))

    Xl = rs.randn(8000, 12).astype(np.float32)
    theta = np.zeros(12, np.float32)
    theta[[1, 5, 9]] = [2.0, -1.0, 3.0]
    yl = (Xl @ theta + 0.01 * rs.randn(8000)).astype(np.float32)
    lasso = LinearRegression(solver="admm", penalty="l1", C=1.0 / 200.0,
                             tol=1e-5, max_iter=500)
    lasso.fit(app.array(Xl, block_shape=(2000, 12)),
              app.array(yl, block_shape=(2000,)))
    support = sorted(np.flatnonzero(
        np.abs(lasso._beta.get()) > 1e-8).tolist())
    out.append(flag(p, "ADMM lasso support", support == [1, 5, 9],
                    support=support))

    sample = app.random_state(7).normal(
        loc=2.0, scale=3.0, shape=(100000,), block_shape=(100000,),
        dtype=np.float32,
    ).get()
    out.append(check(p, "rng normal moments", [sample.mean(), sample.std()],
                     [2.0, 3.0], 2e-2, "n/a"))

    xi = rs.randint(0, 9, size=2048).astype(np.float32)
    bi = app.array(xi, block_shape=(512,))
    out.append(check(p, "device unique", nps.unique(bi).get(),
                     np.unique(xi), 0.0, "n/a"))
    _, counts = nps.unique(bi, return_counts=True)
    out.append(check(p, "device unique counts", counts.get(),
                     np.unique(xi, return_counts=True)[1], 0.0, "n/a"))
    other = np.array([2.0, 5.0, 11.0], np.float32)
    out.append(check(p, "device intersect1d",
                     nps.intersect1d(bi, nps.array(other)).get(),
                     np.intersect1d(xi, other), 0.0, "n/a"))
    mask = xi > 4
    bmask = app.array(mask, block_shape=(512,))
    out.append(check(p, "device extract", nps.extract(bmask, bi).get(),
                     np.extract(mask, xi), 0.0, "n/a"))
    packed = bi.copy()
    fillv = np.arange(mask.sum(), dtype=np.float32)
    packed[bmask] = app.array(fillv, block_shape=(int(mask.sum()),))
    want = xi.copy()
    want[mask] = fillv
    out.append(check(p, "device masked setitem", packed.get(), want, 0.0,
                     "n/a"))

    xa = rs.randn(2000, 20).astype(np.float32)
    ya = rs.randn(2000).astype(np.float32)
    ba = rs.randn(20).astype(np.float32)
    Xa_ = app.array(xa, block_shape=(500, 20))
    ya_ = app.array(ya, block_shape=(500,))

    def lsq(b):
        r = Xa_ @ b - ya_
        return (r * r).sum()

    _, g = autodiff.value_and_grad(lsq)(app.array(ba, block_shape=(20,)))
    xa64 = xa.astype(np.float64)
    out.append(check(p, "autodiff least-squares gradient", g.get(),
                     2.0 * xa64.T @ (xa64 @ ba - ya), TOL_TF32, "default"))

    summa.LAST_DISPATCH = None
    xs = rs.randn(512, 256).astype(np.float32)
    bs = app.array(xs, block_shape=(256, 256))
    out.append(check(p, "single-device tensordot", (bs.T @ bs).get(),
                     xs.astype(np.float64).T @ xs, TOL_TF32, "default"))
    out.append(flag(p, "summa declines on one device",
                    summa.LAST_DISPATCH in (None, "xla"),
                    last_dispatch=summa.LAST_DISPATCH))
    return out


def phase_mesh(app, cfg, _workdir):
    """The mesh backend over four devices: gram and fused Newton at
    10M x 1000 (10 GB per card), a ragged N, and the ring and SUMMA
    collective matmuls on a (2, 2) mesh, each against one device."""
    import jax
    import jax.numpy as jnp

    from nums_tpu.core import settings
    from nums_tpu.core.array.application import ArrayApplication
    from nums_tpu.core.backend import MeshBackend
    from nums_tpu.core.grid import ArrayGrid
    from nums_tpu.core.io.filesystem import FileSystem
    from nums_tpu.core.ops import summa

    p = "mesh"
    out = []
    kind = device_info()["kind"]
    hi = jax.lax.Precision.HIGHEST
    chunk = cfg["ref_chunk_rows"]
    iters = cfg["newton_iters"]
    backend = app.backend
    out.append(flag(p, "mesh backend over 4 devices",
                    backend.name == "mesh" and backend.num_devices == 4,
                    backend=backend.name, mesh=list(backend.cluster_shape)
                    if backend.name == "mesh" else None))
    if backend.name != "mesh":
        return out
    dev0 = jax.devices()[0]

    for label, (n, d) in (("", cfg["mesh"]), ("ragged ", cfg["mesh_ragged"])):
        rows = -(-n // backend.num_devices)
        grid = ArrayGrid((n, d), (rows, d), "float32")
        sh = backend.sharding_for_grid(grid)
        Xd = gen_matrix((n, d)) if n % backend.num_devices else \
            gen_matrix((n, d), sharding=sh)
        X = as_blockarray(app, Xd, rows)
        devs = sorted(str(dv) for dv in X.raw.sharding.device_set)
        out.append(flag(p, f"{label}X shards on 4 devices",
                        len(devs) == 4, device_set=devs,
                        raw_shape=list(X.raw.shape)))
        with jax.default_device(dev0):
            G_ref = np.asarray(chunked_reference(n, d, chunk, hi))
        G, first, warm = timed(lambda: (X.T @ X).raw)
        out.append(check(p, f"{label}gram {n}x{d} vs one device HIGHEST",
                         np.asarray(G)[:d, :d], G_ref, TOL_TF32, "default",
                         **timing(first, warm), roofline_cards=4,
                         **roofline(kind, 2.0 * n * d * d, 4.0 * n * d,
                                    warm * 4, "tf32_flops")))
        with jax.default_matmul_precision("highest"):
            G_hi = np.asarray((X.T @ X).raw)[:d, :d]
        out.append(check(p, f"{label}gram HIGHEST vs one device HIGHEST",
                         G_hi, G_ref, TOL_HIGHEST, "highest"))

        yd = gen_labels(Xd)
        y = as_blockarray(app, yd, rows)
        t0 = time.perf_counter()
        beta, _ = _fit(X, y, iters, fuse=True)
        fit_s = time.perf_counter() - t0
        with jax.default_device(dev0):
            b_ref = np.asarray(chunked_reference(n, d, chunk, hi,
                                                 iters=iters))
        out.append(check(p, f"{label}fused fit ({iters} iters) vs one "
                         "device HIGHEST", beta, b_ref, TOL_NEWTON_TF32,
                         "default", first_call_s=fit_s))
        del X, Xd, y, yd

    m = cfg["mesh_gemm"]
    b22 = MeshBackend(cluster_shape=(2, 2)).init()
    app22 = ArrayApplication(b22, FileSystem(b22))
    with jax.default_device(dev0):
        C_ref = np.asarray(jax.jit(lambda a, b: jnp.matmul(
            a, b, precision=hi))(gen_matrix((m, m), seed=21),
                                 gen_matrix((m, m), seed=22)))
    gsh = app22.backend.sharding_for_shape((m, m))
    A = as_blockarray(app22, gen_matrix((m, m), seed=21, sharding=gsh),
                      m // 2)
    B = as_blockarray(app22, gen_matrix((m, m), seed=22, sharding=gsh),
                      m // 2)
    prev = settings.collective_matmul
    try:
        for mode in ("ring", "summa"):
            settings.collective_matmul = mode
            summa.LAST_DISPATCH = None
            C, first, warm = timed(lambda: (A @ B).raw, reps=2)
            out.append(check(p, f"{mode} {m}x{m} on (2, 2) vs one device "
                             "HIGHEST", np.asarray(C)[:m, :m], C_ref,
                             TOL_TF32, "default", dispatch=summa.LAST_DISPATCH,
                             **timing(first, warm)))
            out.append(flag(p, f"{mode} schedule ran",
                            summa.LAST_DISPATCH == mode,
                            dispatch=summa.LAST_DISPATCH))
    finally:
        settings.collective_matmul = prev
    return out


ONE_CARD = [("gram", phase_gram), ("newton", phase_newton),
            ("tsqr", phase_tsqr), ("ooc", phase_ooc),
            ("surface", phase_surface)]
FOUR_CARDS = [("mesh", phase_mesh)]


def phases_for(cards):
    return FOUR_CARDS if cards == 4 else ONE_CARD


def run_phase(name, fn, app, cfg, workdir):
    """Run one phase; an exception fails it (traceback to stderr)."""
    t0 = time.perf_counter()
    try:
        checks = fn(app, cfg, workdir)
        ok = bool(checks) and all(c["ok"] for c in checks)
        error = None
    except Exception as e:  # noqa: BLE001 - the phase fails, run goes on
        traceback.print_exc()
        ok, checks, error = False, [], f"{type(e).__name__}: {e}"[:500]
    emit({"phase": name, "ok": ok, "checks": len(checks),
          "seconds": time.perf_counter() - t0,
          "peak_bytes_in_use": peak_bytes(), "error": error})
    return ok


def last_line(ok, info):
    return json.dumps({"ok": bool(ok), "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cards", type=int, choices=(1, 4), default=1,
                        help="4: run only the mesh phase over four GPUs")
    args = parser.parse_args(argv)

    import jax

    info = device_info()
    smi = nvidia_smi()
    emit({"card": smi, "device_kind": info["kind"], "count": info["count"],
          "platform": info["platform"], "jax": jax.__version__})
    print(smi, flush=True)
    ok = all(c["ok"] for c in phase_device(None, FULL, None, args.cards))
    emit({"phase": "device", "ok": ok})
    if ok:
        if args.cards == 4:
            os.environ["NUMS_TPU_BACKEND"] = "mesh"
        import nums_tpu
        from nums_tpu.core import application_manager, settings

        settings.backend_name = "mesh" if args.cards == 4 else "serial"
        application_manager.destroy()
        app = nums_tpu.init()
        emit({"backend": app.backend.name,
              "devices": app.backend.num_devices,
              "matmul_precision": settings.matmul_precision,
              "x64": bool(jax.config.jax_enable_x64)})
        try:
            for name, fn in phases_for(args.cards):
                ok &= run_phase(name, fn, app, FULL, WORK_DIR)
        finally:
            shutil.rmtree(WORK_DIR, ignore_errors=True)
        print(smi, flush=True)
    print(last_line(ok, info), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
