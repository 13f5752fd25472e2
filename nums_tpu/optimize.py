"""Generic first-order optimization over BlockArray objectives.

``minimize`` drives any scalar function written against the public
array API: gradients come from :mod:`nums_tpu.autodiff` (the recorded
op DAG transposed into one cached XLA program), parameter updates from
optax (adam/sgd/momentum/…) applied on the raw device buffers. This
generalizes the hand-fused GLM solvers (``models/fast_glm``) to
arbitrary user objectives — something the reference cannot express at
all (its per-block tasks are not differentiable).

    from nums_tpu import optimize

    def loss(beta):
        r = X @ beta - y
        return (r * r).sum() / len(y_np)

    result = optimize.minimize(loss, beta0, method="adam",
                               learning_rate=0.1, steps=200)
    result.x, result.fun, result.n_iter
"""

import dataclasses

import numpy as np

from nums_tpu import autodiff
from nums_tpu.core.array.blockarray import BlockArray

__all__ = ["minimize", "OptimizeResult"]


@dataclasses.dataclass
class OptimizeResult:
    x: "BlockArray | tuple"  # final parameters (tuple iff x0 was one)
    fun: float             # final objective value
    grad_max: float        # max|g| at the final iterate
    n_iter: int
    converged: bool


def _optimizer(method, learning_rate, **kw):
    import optax

    table = {
        "sgd": lambda: optax.sgd(learning_rate, **kw),
        "momentum": lambda: optax.sgd(
            learning_rate, **{"momentum": 0.9, **kw}
        ),
        "adam": lambda: optax.adam(learning_rate, **kw),
        "adamw": lambda: optax.adamw(learning_rate, **kw),
        "rmsprop": lambda: optax.rmsprop(learning_rate, **kw),
        "adagrad": lambda: optax.adagrad(learning_rate, **kw),
    }
    if method not in table:
        raise ValueError(f"unknown method {method!r}; one of {list(table)}")
    return table[method]()


def minimize(f, x0: BlockArray, method: str = "adam",
             learning_rate: float = 0.1, steps: int = 200,
             tol: float = 1e-6, callback=None, fused: bool = False,
             **optimizer_kwargs):
    """Minimize scalar ``f(x)`` starting from BlockArray ``x0``.

    Each step runs ONE cached value-and-grad program (the whole
    objective expression fused) plus one optax update on the raw
    buffer; the convergence test max|g| <= tol costs one scalar sync
    per step — the same cadence as the reference's solver loops.
    ``callback(step, value, grad_max)`` observes progress.

    ``x0`` may be a single BlockArray or a TUPLE of BlockArrays
    (multi-parameter models — ``f`` then takes one argument per
    parameter and ``result.x`` is a tuple); optax treats the raw
    buffers as one pytree.

    ``fused=True`` compiles the ENTIRE loop — objective, gradient,
    optax update, convergence test — into ONE on-device
    ``lax.while_loop`` program with ZERO per-step host syncs (the
    ``fast_glm`` treatment, for arbitrary objectives; no callback).
    """
    import jax.numpy as jnp

    multi = isinstance(x0, (tuple, list))
    xs = tuple(x0) if multi else (x0,)
    for x in xs:
        assert isinstance(x, BlockArray), type(x)
        x.touch()
    if len({id(x.raw) for x in xs}) != len(xs):
        raise ValueError(
            "parameters share the same underlying buffer (the same "
            "array, or views like x and x.T); pass distinct arrays."
        )
    if fused:
        assert callback is None, "fused=True runs on-device (no callback)"
        return _minimize_fused(
            f, xs, multi, method, learning_rate, int(steps), float(tol),
            optimizer_kwargs,
        )
    vag = autodiff.value_and_grad(f, argnums=tuple(range(len(xs))))
    opt = _optimizer(method, learning_rate, **optimizer_kwargs)
    opt_state = opt.init(tuple(x.raw for x in xs))

    def rewrap(raws, templates):
        return tuple(
            autodiff._rebuild(r, t) for r, t in zip(raws, templates)
        )

    # Invariant: fun and grad_max in the result are evaluated AT the
    # returned x (both exit paths), so res.fun == f(res.x).
    def result(xs, val_ba, gmax, it):
        return OptimizeResult(
            x=xs if multi else xs[0], fun=float(val_ba.get()),
            grad_max=gmax, n_iter=it, converged=gmax <= tol,
        )

    def host_gmax(gs):
        # ONE device-side reduction + one scalar sync (not one per
        # param — each sync stalls the host on the device).
        return float(jnp.max(jnp.asarray(
            [jnp.max(jnp.abs(g.raw)).astype(jnp.float32) for g in gs]
        )))

    it = 0
    for it in range(1, int(steps) + 1):
        val_ba, gs = vag(*xs)
        gmax = host_gmax(gs)
        if callback is not None:
            callback(it, float(val_ba.get()), gmax)
        if gmax <= tol:
            return result(xs, val_ba, gmax, it)
        updates, opt_state = opt.update(
            tuple(g.raw for g in gs), opt_state,
            tuple(x.raw for x in xs),
        )
        import optax

        new_raws = optax.apply_updates(tuple(x.raw for x in xs), updates)
        xs = rewrap(new_raws, xs)
    val_ba, gs = vag(*xs)  # evaluate at the final (returned) iterate
    gmax = host_gmax(gs)
    return result(xs, val_ba, gmax, it)


def _minimize_fused(f, xs, multi, method, learning_rate, steps, tol,
                    opt_kwargs):
    """The whole optimization as ONE XLA program: a lax.while_loop over
    (value_and_grad → optax update), cached by graph structure +
    optimizer config. Zero host syncs until the final fetch. Supports a
    tuple of parameters (one while_loop over the whole pytree)."""
    import jax
    import jax.numpy as jnp

    from nums_tpu.core import lazy, settings

    if not settings.lazy_batch:
        raise RuntimeError("fused minimize requires NUMS_TPU_LAZY=1")
    for x in xs:
        assert isinstance(x, BlockArray), type(x)
        x.touch()
    out = autodiff._trace_pure(f, xs, {})
    assert isinstance(out, BlockArray) and out.shape == (), (
        "f must return a scalar BlockArray"
    )
    root = out._data
    assert isinstance(root, lazy.LazyOut), "graph severed inside f"
    run_root, leaves, leaf_pos, key = lazy.program_for(
        root, forbid_interior_constants=True
    )
    lis = []
    for i, x in enumerate(xs):
        li = leaf_pos.get(id(x.raw))
        if li is None:
            raise RuntimeError(
                f"x0[{i}] is not reachable in f's recorded graph"
            )
        lis.append(li)
    lis = tuple(lis)
    opt_items = tuple(sorted(opt_kwargs.items()))

    def build():
        opt = _optimizer(method, learning_rate, **dict(opt_items))

        def fused(tol_v, *leaf_vals):
            import optax

            def f_of_params(params):
                vals = list(leaf_vals)
                for li, p in zip(lis, params):
                    vals[li] = p
                return run_root(*vals)

            def gmax_of(gs):
                # Fixed carry dtype regardless of (mixed) param dtypes.
                return jnp.max(jnp.asarray(
                    [jnp.max(jnp.abs(g)).astype(jnp.float32) for g in gs]
                ))

            def cond(c):
                it, _, _, gmax = c
                return jnp.logical_and(it < steps, gmax > tol_v)

            def body(c):
                it, params, st, _ = c
                gs = jax.grad(f_of_params)(params)
                upd, st = opt.update(gs, st, params)
                params = optax.apply_updates(params, upd)
                return it + 1, params, st, gmax_of(gs)

            p0 = tuple(leaf_vals[li] for li in lis)
            init = (jnp.int32(0), p0, opt.init(p0),
                    jnp.asarray(jnp.inf, jnp.float32))
            it, params, _, _ = jax.lax.while_loop(cond, body, init)
            # Value AND gradient at the RETURNED params (invariant).
            val, g_final = jax.value_and_grad(f_of_params)(params)
            return params, val, gmax_of(g_final), it

        return jax.jit(fused)

    executor = lazy.cached_executor(
        ("fmin", key, lis, method, learning_rate, steps, opt_items), build
    )
    raws, val, gmax, it = executor(tol, *leaves)
    outs = tuple(
        BlockArray(r, x.grid.copy(), x.backend, transposed=x.is_transposed)
        for r, x in zip(raws, xs)
    )
    gmax_f = float(gmax)
    return OptimizeResult(
        x=outs if multi else outs[0], fun=float(val), grad_max=gmax_f,
        n_iter=int(it), converged=gmax_f <= tol,
    )
