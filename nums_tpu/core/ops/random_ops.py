"""Random sampling kernels on JAX's counter-based PRNG.

Replaces the reference's per-block PCG64 jump-ahead streams
(``block_rng``/``RNG``, numpy_compute.py:29-81): jax's threefry is
counter-based, so ONE whole-array sample is deterministic in (seed, shape)
and independent of sharding/block shape — the property the reference's
jump-ahead construction works to preserve (numpy_compute.py:56-68) holds
here by construction.

Distributions not in ``jax.random`` are derived by standard transforms;
a few awkward discrete ones fall back to host NumPy in the state object
(see nums_tpu/core/array/random.py).
"""

import functools

import jax
import jax.numpy as jnp
import jax.random as jr

from nums_tpu.core.ops import creation


def _u(key, shape, dtype):
    # Uniform in (0, 1): avoids log(0) in inversion transforms.
    return jr.uniform(
        key, shape, dtype, minval=jnp.finfo(dtype).tiny, maxval=1.0
    )


# Each impl: fn(key, shape, dtype, *params) -> array of `shape`/`dtype`.
_DISTS = {
    "random": lambda key, shape, dtype: jr.uniform(key, shape, dtype),
    "uniform": lambda key, shape, dtype, low, high: jr.uniform(
        key, shape, dtype, minval=low, maxval=high
    ),
    "normal": lambda key, shape, dtype, loc, scale: loc
    + scale * jr.normal(key, shape, dtype),
    "beta": lambda key, shape, dtype, a, b: jr.beta(key, a, b, shape, dtype),
    "binomial": lambda key, shape, dtype, n, p: jr.binomial(
        key, n, p, shape, dtype
    ),
    "chisquare": lambda key, shape, dtype, df: jr.chisquare(
        key, df, shape, dtype
    ),
    "exponential": lambda key, shape, dtype, scale: scale
    * jr.exponential(key, shape, dtype),
    "f": lambda key, shape, dtype, dfnum, dfden: jr.f(
        key, dfnum, dfden, shape, dtype
    ),
    "gamma": lambda key, shape, dtype, k, theta: theta
    * jr.gamma(key, k, shape, dtype),
    "geometric": lambda key, shape, dtype, p: jr.geometric(
        key, p, shape, jnp.int32
    ).astype(dtype),
    "gumbel": lambda key, shape, dtype, loc, scale: loc
    + scale * jr.gumbel(key, shape, dtype),
    "laplace": lambda key, shape, dtype, loc, scale: loc
    + scale * jr.laplace(key, shape, dtype),
    "logistic": lambda key, shape, dtype, loc, scale: loc
    + scale * jr.logistic(key, shape, dtype),
    "lognormal": lambda key, shape, dtype, mean, sigma: jnp.exp(
        mean + sigma * jr.normal(key, shape, dtype)
    ),
    # NumPy's pareto is the Lomax (Pareto-II minus 1).
    "pareto": lambda key, shape, dtype, a: jr.pareto(key, a, shape, dtype)
    - 1.0,
    "poisson": lambda key, shape, dtype, lam: jr.poisson(
        key, lam, shape
    ).astype(dtype),
    # power(a): density a·x^(a-1) on [0,1] == U^(1/a).
    "power": lambda key, shape, dtype, a: _u(key, shape, dtype) ** (1.0 / a),
    "rayleigh": lambda key, shape, dtype, scale: jr.rayleigh(
        key, scale, shape, dtype
    ),
    "standard_cauchy": lambda key, shape, dtype: jr.cauchy(
        key, shape, dtype
    ),
    "standard_t": lambda key, shape, dtype, df: jr.t(key, df, shape, dtype),
    "triangular": lambda key, shape, dtype, left, mode, right: jr.triangular(
        key, left, mode, right, shape, dtype
    ),
    # jr.wald(mean) is IG(mean, lambda=1); c*IG(mu, 1) = IG(c*mu, c), so
    # numpy's IG(mean, scale) is scale * IG(mean/scale, 1) — scaling the
    # mean-`mean` draw directly would return IG(scale*mean, scale).
    "wald": lambda key, shape, dtype, mean, scale: jr.wald(
        key, mean / scale, shape, dtype
    )
    * scale,
    # NumPy weibull(a): scale-1 Weibull == (-ln U)^(1/a).
    "weibull": lambda key, shape, dtype, a: (-jnp.log(_u(key, shape, dtype)))
    ** (1.0 / a),
    # negative_binomial(n, p) == Poisson(Gamma(n, (1-p)/p)).
    "negative_binomial": lambda key, shape, dtype, n, p: _negative_binomial(
        key, shape, dtype, n, p
    ),
    "noncentral_chisquare": lambda key, shape, dtype, df, nonc: (
        _noncentral_chisquare(key, shape, dtype, df, nonc)
    ),
    "noncentral_f": lambda key, shape, dtype, dfnum, dfden, nonc: (
        _noncentral_f(key, shape, dtype, dfnum, dfden, nonc)
    ),
    # Device-side rejection/inversion samplers (the reference jumps PCG64
    # per block on the host for these).
    "vonmises": lambda key, shape, dtype, mu, kappa: _vonmises(
        key, shape, dtype, mu, kappa
    ),
    "zipf": lambda key, shape, dtype, a: _zipf(key, shape, dtype, a),
    "logseries": lambda key, shape, dtype, p: _logseries(
        key, shape, dtype, p
    ),
}


_REJECTION_ROUNDS = 32  # per-element failure prob < 1e-9 for our samplers


def _rejection_sample(key, shape, dtype, propose_accept, fallback):
    """Fixed-round rejection sampling (jittable: static shapes + masks).

    propose_accept(subkey) -> (proposal, accepted_mask); after
    _REJECTION_ROUNDS rounds any still-unaccepted elements (probability
    ~1e-9 per element) take `fallback`.
    """
    out = jnp.full(shape, fallback, dtype)
    done = jnp.zeros(shape, jnp.bool_)

    def body(i, carry):
        out, done = carry
        sub = jr.fold_in(key, i)
        proposal, accept = propose_accept(sub)
        take = jnp.logical_and(accept, jnp.logical_not(done))
        return jnp.where(take, proposal, out), jnp.logical_or(done, accept)

    out, _ = jax.lax.fori_loop(0, _REJECTION_ROUNDS, body, (out, done))
    return out


def _vonmises(key, shape, dtype, mu, kappa):
    """Best–Fisher (1979) rejection sampler for the von Mises circle."""
    kappa = jnp.maximum(jnp.asarray(kappa, dtype), 1e-8)
    tau = 1.0 + jnp.sqrt(1.0 + 4.0 * kappa * kappa)
    rho = (tau - jnp.sqrt(2.0 * tau)) / (2.0 * kappa)
    r = (1.0 + rho * rho) / (2.0 * rho)

    def propose(sub):
        k1, k2, k3 = jr.split(sub, 3)
        u1 = jr.uniform(k1, shape, dtype, minval=1e-7, maxval=1.0)
        u2 = jr.uniform(k2, shape, dtype, minval=1e-7, maxval=1.0)
        u3 = jr.uniform(k3, shape, dtype)
        z = jnp.cos(jnp.pi * u1)
        f = (1.0 + r * z) / (r + z)
        c = kappa * (r - f)
        accept = jnp.logical_or(
            c * (2.0 - c) - u2 > 0.0, jnp.log(c / u2) + 1.0 - c >= 0.0
        )
        theta = jnp.where(u3 < 0.5, -jnp.arccos(f), jnp.arccos(f))
        return mu + theta, accept

    raw = _rejection_sample(key, shape, dtype, propose, 0.0)
    # wrap to [-pi, pi) like np.random.vonmises
    return jnp.mod(raw + jnp.pi, 2.0 * jnp.pi) - jnp.pi


def _zipf(key, shape, dtype, a):
    """Devroye's rejection sampler for the Zipf(a) distribution."""
    am1 = a - 1.0
    b = 2.0 ** am1

    def propose(sub):
        k1, k2 = jr.split(sub)
        u = jr.uniform(k1, shape, jnp.float32, minval=1e-7, maxval=1.0)
        v = jr.uniform(k2, shape, jnp.float32)
        # cap x to avoid overflow; tail mass beyond 1e9 is negligible
        x = jnp.floor(jnp.minimum(u ** (-1.0 / am1), 1e9))
        t = (1.0 + 1.0 / x) ** am1
        accept = v * x * (t - 1.0) / (b - 1.0) <= t / b
        return x.astype(dtype), accept

    return _rejection_sample(key, shape, dtype, propose, 1.0)


def _logseries(key, shape, dtype, p):
    """Kemp's inversion sampler for the log-series distribution."""
    k1, k2 = jr.split(key)
    r = jnp.log1p(-p)
    v = jr.uniform(k1, shape, jnp.float32, minval=1e-7, maxval=1.0)
    u = jr.uniform(k2, shape, jnp.float32, minval=1e-7, maxval=1.0)
    q = -jnp.expm1(r * u)
    # Kemp's branch order: V>=p -> 1; V<=q^2 -> floor(1+lnV/lnq);
    # V>=q -> 1; else -> 2.
    x = jnp.where(
        v >= p,
        1.0,
        jnp.where(
            v <= q * q,
            jnp.floor(1.0 + jnp.log(v) / jnp.log(q)),
            jnp.where(v >= q, 1.0, 2.0),
        ),
    )
    return x.astype(dtype)


def _negative_binomial(key, shape, dtype, n, p):
    k1, k2 = jr.split(key)
    lam = jr.gamma(k1, n, shape, jnp.float32) * ((1.0 - p) / p)
    return jr.poisson(k2, lam, shape).astype(dtype)


def _noncentral_chisquare(key, shape, dtype, df, nonc):
    """numpy's two-regime construction: chi2(df-1) + (Z+sqrt(nonc))^2
    for df > 1, the Poisson mixture chi2(df + 2*Poisson(nonc/2)) for
    df <= 1 (the decomposition needs df-1 > 0; a negative-shape gamma
    is NaN). df is traced, so both regimes are sampled and selected —
    sampling is not a hot path."""
    k1, k2, k3, k4 = jr.split(key, 4)
    dfa = jnp.asarray(df, dtype)
    central = jr.chisquare(k1, jnp.maximum(dfa - 1.0, 1e-6), shape, dtype)
    shifted = (jr.normal(k2, shape, dtype) + jnp.sqrt(nonc)) ** 2
    i = jr.poisson(k3, jnp.asarray(nonc, jnp.float32) / 2.0, shape)
    mixture = jr.chisquare(k4, dfa + 2.0 * i.astype(dtype), shape, dtype)
    return jnp.where(dfa > 1.0, central + shifted, mixture)


def _noncentral_f(key, shape, dtype, dfnum, dfden, nonc):
    # Independent keys via ONE split: mixing fold_in(key, i) with
    # split(key) collides (threefry split == fold_in over indices), which
    # previously fed the denominator chi2 the numerator's normal key.
    k_num, k_den = jr.split(key)
    num = _noncentral_chisquare(k_num, shape, dtype, dfnum, nonc) / dfnum
    den = jr.chisquare(k_den, dfden, shape, dtype) / dfden
    return num / den


def supported(name: str) -> bool:
    return name in _DISTS


@functools.lru_cache(maxsize=None)
def hypergeometric(shape: tuple, dtype_name: str, nsample: int, sharding,
                   pshape: tuple = None):
    """Exact sequential without-replacement sampler (jittable).

    k = Σ_{t<nsample} Bernoulli(good_t / (good_t + bad_t)) with the urn
    updated each draw — the chain-rule factorization of the
    hypergeometric pmf, vectorized over the output shape. nsample is
    static (one unrolled fori_loop bound per value); the reference
    samples this distribution on the HOST with a jumped PCG64 per block
    (numpy_compute.py:29-81) — here it stays on device.
    """
    dtype = jnp.dtype(dtype_name)

    def impl(key, ngood, nbad):
        # Urn counts in int32: exact updates for populations up to
        # 2^31 (f32 counts silently stop depleting above 2^24 — the
        # chain degenerates to i.i.d. Bernoulli). The f32 CAST in the
        # accept test only perturbs the ratio in its 7th digit.
        good0 = jnp.full(shape, ngood, jnp.int32)
        bad0 = jnp.full(shape, nbad, jnp.int32)
        k0 = jnp.zeros(shape, jnp.int32)

        def body(t, carry):
            good, bad, k = carry
            u = jr.uniform(jr.fold_in(key, t), shape, jnp.float32)
            goodf = good.astype(jnp.float32)
            take = (
                u * (goodf + bad.astype(jnp.float32)) < goodf
            ).astype(jnp.int32)
            return good - take, bad - (1 - take), k + take

        _, _, k = jax.lax.fori_loop(0, int(nsample), body, (good0, bad0, k0))
        return _pad_phys(k.astype(dtype), pshape)

    return jax.jit(impl, out_shardings=sharding)


# Device path is O(nsample) sequential draws per element; beyond this,
# the host generator is faster than the unrolled chain.
HYPERGEOMETRIC_DEVICE_MAX_NSAMPLE = 4096


# Samples MUST be drawn at the logical shape — threefry counters map to
# flat positions, so drawing at the padded shape would break the
# "same seed ⇒ same array under any sharding/backend" invariant. The
# shared pad helper (canonical copy + the zero-pad contract note lives
# in ops/creation.py) zero-fills the at-rest pad region afterwards.
_pad_phys = creation._pad_phys


@functools.lru_cache(maxsize=None)
def sample(dist_name: str, shape: tuple, dtype_name: str, sharding,
           pshape: tuple = None):
    impl = _DISTS[dist_name]
    dtype = jnp.dtype(dtype_name)
    fn = jax.jit(
        lambda key, *args: _pad_phys(impl(key, shape, dtype, *args), pshape),
        out_shardings=sharding,
    )
    return fn


@functools.lru_cache(maxsize=None)
def integers(shape: tuple, dtype_name: str, endpoint: bool, sharding,
             pshape: tuple = None):
    dtype = jnp.dtype(dtype_name)

    def impl(key, low, high):
        if endpoint:
            # Draw on [low-1, high) and add 1: high+1 would overflow to
            # the dtype minimum when high is the dtype max (int32 on
            # an accelerator, where x64 stays off), inverting the range.
            draws = jr.randint(key, shape, low - 1, high, dtype) + 1
        else:
            draws = jr.randint(key, shape, low, high, dtype)
        return _pad_phys(draws, pshape)

    return jax.jit(impl, out_shardings=sharding)


@functools.lru_cache(maxsize=None)
def permutation(n: int, sharding, pshape: tuple = None):
    return jax.jit(
        lambda key: _pad_phys(jr.permutation(key, n), pshape),
        out_shardings=sharding,
    )
