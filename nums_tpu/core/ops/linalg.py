"""Distributed linear algebra kernels: TSQR, SVD, inv, Cholesky.

Parity targets (semantics, not structure):
- ``indirect_tsr``/``indirect_tsqr`` — application.py:772-846
- ``direct_tsqr`` — application.py:848-933
- ``svd`` — application.py:935-954
- ``inv``/``cholesky`` — application.py:956-1001

The reference reduces per-row-strip R factors through a SINGLE-node fan-in
(application.py:807-814) and notes the missing recursive extension
(application.py:884). Here TSQR is a log-depth reduction tree expressed as
batched (vmapped) panel QRs inside one jitted program: XLA batches the
panel QRs and, for row-sharded inputs, partitions the tree across
devices with all-gathers. Zero-row padding is exact for R
(QR([X;0]) has the same R as QR(X)), so ragged chunks cost nothing.
"""

import functools

import jax
import jax.numpy as jnp


def _cdiv(a, b):
    return -(-a // b)


# Rows per leaf panel. Large enough to amortize QR overhead, small
# enough that a batch of (chunk, n<=512) panels stays cheap.
DEFAULT_CHUNK = 8192


def _pad_rows(x, target_rows):
    m, n = x.shape
    if target_rows == m:
        return x
    return jnp.concatenate(
        [x, jnp.zeros((target_rows - m, n), dtype=x.dtype)], axis=0
    )


def _tsqr_r_impl(x, chunk):
    """R factor of a tall-skinny matrix via a recursive panel-QR tree."""
    m, n = x.shape
    chunk = max(chunk, n)
    while m > chunk:
        k = _cdiv(m, chunk)
        x = _pad_rows(x, k * chunk)
        panels = x.reshape(k, chunk, n)
        rs = jnp.linalg.qr(panels, mode="r")  # (k, n, n), batched
        x = rs.reshape(k * n, n)
        m = k * n
    return jnp.linalg.qr(x, mode="r")


@functools.lru_cache(maxsize=None)
def tsqr_r(chunk: int = DEFAULT_CHUNK):
    return jax.jit(lambda x: _tsqr_r_impl(x, chunk))


def _direct_tsqr_impl(x, chunk):
    """(Q, R) via recursive direct TSQR.

    Leaf: per-panel reduced QR. Combine: TSQR of the stacked R factors;
    each panel's Q is updated by its n×n slice of the combine Q. Recursion
    extends the reference's one-level tree (its TODO at
    application.py:884) to arbitrary depth.
    """
    m, n = x.shape
    chunk = max(chunk, n)
    if m <= chunk:
        return jnp.linalg.qr(x, mode="reduced")
    k = _cdiv(m, chunk)
    padded = k * chunk
    xp = _pad_rows(x, padded)
    panels = xp.reshape(k, chunk, n)
    q1, r1 = jnp.linalg.qr(panels, mode="reduced")  # (k,chunk,n), (k,n,n)
    q2, r = _direct_tsqr_impl(r1.reshape(k * n, n), chunk)
    q2 = q2.reshape(k, n, n)
    q = jnp.einsum(
        "kcn,knm->kcm", q1, q2, precision=jax.lax.Precision.HIGHEST
    ).reshape(padded, n)
    return q[:m], r


@functools.lru_cache(maxsize=None)
def direct_tsqr(chunk: int = DEFAULT_CHUNK):
    return jax.jit(lambda x: _direct_tsqr_impl(x, chunk))


def _svd_impl(x, chunk):
    """Tall-skinny SVD via TSQR (parity: application.py:935-954)."""
    q, r = _direct_tsqr_impl(x, chunk)
    u_r, s, vt = jnp.linalg.svd(r, full_matrices=False)
    u = q @ u_r
    return u, s, vt


@functools.lru_cache(maxsize=None)
def svd(chunk: int = DEFAULT_CHUNK):
    return jax.jit(lambda x: _svd_impl(x, chunk))


def _randomized_svd_impl(x, omega, k, n_iter, chunk):
    """Halko randomized top-k SVD as ONE program: sketch, power
    iterations with TSQR re-orthonormalization, small SVD, back-project.
    GEMMs run at HIGHEST precision — the sketch width ell ≪ n makes the
    3-pass fp32 cost negligible next to the accuracy it buys the power
    iterations."""
    hi = jax.lax.Precision.HIGHEST
    mm = functools.partial(jnp.matmul, precision=hi)
    q, _ = _direct_tsqr_impl(mm(x, omega), chunk)
    for _ in range(n_iter):  # static unroll
        z, _ = _direct_tsqr_impl(mm(x.T, q), chunk)
        q, _ = _direct_tsqr_impl(mm(x, z), chunk)
    b = mm(q.T, x)  # (ell, n)
    ub, s, vt = jnp.linalg.svd(b, full_matrices=False)
    u = mm(q, ub)
    return u[:, :k], s[:k], vt[:k]


@functools.lru_cache(maxsize=None)
def randomized_svd(k: int, n_iter: int, chunk: int = DEFAULT_CHUNK):
    return jax.jit(
        lambda x, omega: _randomized_svd_impl(x, omega, k, n_iter, chunk)
    )


_COMP_CHUNK = 4096
_COMP_MIN_ROWS = 1 << 20
# Chunk-gram stack ceiling for the batched+tree form (see _gram).
_COMP_STACK_BYTES = 512 << 20


def _gram(x, precision, compensated=None):
    """G = XᵀX with compensated accumulation on tall inputs.

    A single f32 dot over M=2^24 rows floors orthogonality at
    ~sqrt(M)·eps ≈ 1e-4 (round-1 measured 7.6e-5 at 2^24×128). Splitting
    into 4096-row chunk-grams caps the in-GEMM accumulation depth at
    sqrt(chunk)·eps ≈ 4e-6 while every flop stays a full-width
    GEMM. The chunk SUM has two shapes, chosen by the (c, n, n)
    chunk-gram stack size:

    - stack ≤ ~0.5 GB (narrow n, e.g. the 2^24×128 TSQR: 268 MB): ONE
      batched GEMM for all chunk-grams + a pairwise tree-sum. A scanned
      loop here serializes 4096 tiny GEMMs.
    - stack > ~0.5 GB (wide n, e.g. 2.5M×1000: 2.4 GB): a scanned loop
      with a KAHAN (accumulator, compensation) carry — O(n²) extra
      memory, one read of X. The batched form would materialize the
      stack and re-read it log₂(c) times. Kahan also bounds
      cross-chunk error at O(eps), tighter than the tree's log₂(c)
      ulps.

    Auto-enabled for M ≥ 2^20 float32 inputs.
    """
    m, n = x.shape
    if compensated is None:
        compensated = m >= _COMP_MIN_ROWS and x.dtype == jnp.float32
    dn = (((0,), (0,)), ((), ()))
    if not compensated or m <= _COMP_CHUNK:
        return jax.lax.dot_general(x, x, dn, precision=precision)
    c = m // _COMP_CHUNK
    head = jax.lax.slice(x, (0, 0), (c * _COMP_CHUNK, n)).reshape(
        c, _COMP_CHUNK, n
    )
    stack_bytes = c * n * n * x.dtype.itemsize
    if stack_bytes <= _COMP_STACK_BYTES:
        grams = jax.lax.dot_general(
            head, head, (((1,), (1,)), ((0,), (0,))),
            precision=precision,
        )  # (c, n, n)
        while grams.shape[0] > 1:
            k = grams.shape[0]
            if k % 2:
                odd = grams[k - 1]
                grams = grams[0:k - 1:2] + grams[1:k:2]
                grams = grams.at[0].add(odd)
            else:
                grams = grams[0::2] + grams[1::2]
        s = grams[0]
        rem = m - c * _COMP_CHUNK
        if rem:
            tail = jax.lax.slice(x, (c * _COMP_CHUNK, 0), (m, n))
            s = s + jax.lax.dot_general(
                tail, tail, dn, precision=precision
            )
        return s

    def body(carry, blk):
        s, comp = carry
        g = jax.lax.dot_general(blk, blk, dn, precision=precision)
        y = g - comp
        t = s + y
        comp = (t - s) - y
        return (t, comp), None

    (s, comp), _ = jax.lax.scan(
        body,
        (jnp.zeros((n, n), x.dtype), jnp.zeros((n, n), x.dtype)),
        head,
    )
    rem = m - c * _COMP_CHUNK
    if rem:
        tail = jax.lax.slice(x, (c * _COMP_CHUNK, 0), (m, n))
        g = jax.lax.dot_general(tail, tail, dn, precision=precision)
        s = s + (g - comp)
    return s


def _mm_hi(a, b):
    """(n, n) product of the two R factors at full fp32: at DEFAULT
    precision a GPU runs it in TF32, which alone puts ~1e-4 relative
    error into R (and into every Q·R reconstruction)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _cholqr_once(x, precision):
    """One CholeskyQR pass: G = XᵀX, R = chol(G)ᵀ, Q = X R⁻¹."""
    g = _gram(x, precision)
    r = jnp.linalg.cholesky(g).T  # upper-triangular
    q = jax.lax.linalg.triangular_solve(
        r, x, left_side=False, lower=False
    )
    return q, r


def _cholqr2_impl(x):
    """CholeskyQR2: two passes restore orthogonality to ~eps for
    cond(X) ≲ 1/sqrt(eps). All flops are GEMM/triangular-solve shaped —
    the matrix-unit TSQR (the Householder tree in ``_direct_tsqr_impl`` is
    the numerically-robust fallback)."""
    q1, r1 = _cholqr_once(x, jax.lax.Precision.HIGHEST)
    q, r2 = _cholqr_once(q1, jax.lax.Precision.HIGHEST)
    return q, _mm_hi(r2, r1)


@functools.lru_cache(maxsize=None)
def cholqr2():
    return jax.jit(_cholqr2_impl)


def _cholqr_r_impl(x):
    """R-only CholeskyQR with a Q-free second pass: refines chol(G)
    without materializing Q (G-space refinement), so peak memory is
    X + O(n²). Accuracy is gram-limited (~eps·cond²) like any
    normal-equations method."""
    g = _gram(x, jax.lax.Precision.HIGHEST)
    r1 = jnp.linalg.cholesky(g).T
    # B = R1⁻ᵀ G R1⁻¹ == Q1ᵀQ1 ; R = chol(B)ᵀ R1
    b = jax.lax.linalg.triangular_solve(
        r1, g, left_side=True, lower=False, transpose_a=True
    )
    b = jax.lax.linalg.triangular_solve(
        r1, b, left_side=False, lower=False
    )
    r2 = jnp.linalg.cholesky(b).T
    return _mm_hi(r2, r1)


@functools.lru_cache(maxsize=None)
def cholqr_r():
    return jax.jit(_cholqr_r_impl)


def _inplace_right_mul(buf, rinv, chunk_rows):
    """buf <- buf @ rinv, streamed chunk-wise so XLA updates in place.

    Keeps peak HBM at one (m, n) buffer + O(chunk) — required for
    full-Q TSQR at 2^24×128 on a 16GB chip (two full buffers don't fit).
    """
    m, n = buf.shape
    num = m // chunk_rows
    hi = jax.lax.Precision.HIGHEST  # single-pass bf16 GEMM would cap
    # orthogonality at ~1e-3; full-precision keeps CholeskyQR2 at ~eps.

    def body(i, b):
        chunk = jax.lax.dynamic_slice(b, (i * chunk_rows, 0), (chunk_rows, n))
        return jax.lax.dynamic_update_slice(
            b, jnp.matmul(chunk, rinv, precision=hi), (i * chunk_rows, 0)
        )

    buf = jax.lax.fori_loop(0, num, body, buf)
    rem = m - num * chunk_rows
    if rem:
        tail = jax.lax.dynamic_slice(buf, (num * chunk_rows, 0), (rem, n))
        buf = jax.lax.dynamic_update_slice(
            buf, jnp.matmul(tail, rinv, precision=hi), (num * chunk_rows, 0)
        )
    return buf


def _cholqr2_stream_impl(x, chunk_rows):
    """CholeskyQR2 with the Q-buffer aliased onto (donated) X."""
    chunk_rows = min(chunk_rows, x.shape[0])
    hi = jax.lax.Precision.HIGHEST
    g = _gram(x, hi)
    r1 = jnp.linalg.cholesky(g).T
    q1 = _inplace_right_mul(x, jnp.linalg.inv(r1), chunk_rows)
    g2 = _gram(q1, hi)
    r2 = jnp.linalg.cholesky(g2).T
    q = _inplace_right_mul(q1, jnp.linalg.inv(r2), chunk_rows)
    return q, _mm_hi(r2, r1)


@functools.lru_cache(maxsize=None)
def cholqr2_stream(chunk_rows: int = 2**20):
    """Donating variant: destroys the input buffer; peak HBM ~1x X."""
    return jax.jit(
        lambda x: _cholqr2_stream_impl(x, chunk_rows), donate_argnums=0
    )


def _svd_cholqr_impl(x):
    q, r = _cholqr2_impl(x)
    u_r, s, vt = jnp.linalg.svd(r, full_matrices=False)
    return q @ u_r, s, vt


@functools.lru_cache(maxsize=None)
def svd_cholqr():
    return jax.jit(_svd_cholqr_impl)


@jax.jit
def inv(x):
    return jnp.linalg.inv(x)


@jax.jit
def cholesky(x):
    return jnp.linalg.cholesky(x)


def _lstsq_impl(x, y, chunk):
    q, r = _direct_tsqr_impl(x, chunk)
    return jax.scipy.linalg.solve_triangular(r, q.T @ y, lower=False)


@functools.lru_cache(maxsize=None)
def lstsq(chunk: int = DEFAULT_CHUNK):
    return jax.jit(lambda x, y: _lstsq_impl(x, y, chunk))


def _lstsq_cholqr_impl(x, y):
    q, r = _cholqr2_impl(x)
    return jax.scipy.linalg.solve_triangular(r, q.T @ y, lower=False)


@functools.lru_cache(maxsize=None)
def lstsq_cholqr():
    return jax.jit(_lstsq_cholqr_impl)


def _posdef_solve_impl(a, b):
    """Solve a x = b for symmetric positive-definite a via Cholesky."""
    l = jnp.linalg.cholesky(a)
    z = jax.scipy.linalg.solve_triangular(l, b, lower=True)
    return jax.scipy.linalg.solve_triangular(l.T, z, lower=False)


posdef_solve = jax.jit(_posdef_solve_impl)


def choose_chunk(m: int, n: int) -> int:
    """Pick a leaf panel size: a few GEMM-sized panels per level."""
    base = max(int(n), DEFAULT_CHUNK)
    return int(min(m, base)) if m > 0 else base
