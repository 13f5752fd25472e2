"""Deferred-expression engine: eager per EXPRESSION, not per op.

The reference is eager per *block task*; round 1 of this build was eager
per *op* (one jitted XLA program per BlockArray operation). This module
upgrades that to eager per *expression* (SURVEY hard-part #7): kernel
invocations build a tiny DAG instead of executing, and the first sync
point (``get``/``touch``/``float()``/IO/...) compiles the WHOLE chain
into ONE jitted program. Wins:

- one dispatch per sync point instead of one per op (host dispatch
  latency dominates small-N programs);
- XLA fuses across ops (elementwise chains ride along matmuls for free);
- repeated structures (e.g. one GLM Newton iteration) hit the program
  cache after the first materialization — same key, zero retrace.

Programs are cached by STRUCTURAL key (kernel identities + topology +
leaf avals), so value changes never retrace. Shared subexpressions are
deduplicated by node identity, and materialized results are stored on
their node so later roots reuse them as concrete leaves.

Disable with ``NUMS_TPU_LAZY=0`` (ops then execute immediately, round-1
behavior).
"""

import collections
import threading
import weakref

import numpy as np

import jax

from nums_tpu.core import settings


def _is_scalar(x):
    return isinstance(
        x, (bool, int, float, complex, np.bool_, np.number)
    )


class _Ref:
    """In-graph edge to another call's output. Deliberately NOT a LazyOut:
    graph-internal references must not keep user handles alive, so that
    liveness of a LazyOut == 'some BlockArray still wants this value'."""

    __slots__ = ("call", "idx")

    def __init__(self, call, idx):
        self.call = call
        self.idx = idx


class LazyCall:
    """One deferred kernel invocation (possibly multi-output)."""

    __slots__ = (
        "fn", "args", "avals", "results", "depth", "handles", "consumers",
        "__weakref__",
    )

    def __init__(self, fn, args, avals, depth):
        self.fn = fn
        self.args = args  # _Ref | concrete array | scalar
        self.avals = avals  # tuple of ShapeDtypeStruct, one per output
        self.results = None  # tuple of jax.Array once materialized
        self.depth = depth
        self.handles = weakref.WeakSet()  # live user-facing LazyOuts
        # Downstream calls referencing this one (weak): lets materialize
        # store a handle-less interior value that a SIBLING pending root
        # still needs, instead of recomputing its subtree per root.
        self.consumers = weakref.WeakSet()


class LazyOut:
    """User-facing handle to one output of a LazyCall.

    Liveness matters: materialize() stores concrete results for exactly
    the calls whose handles are still referenced (plus the root) — dead
    temporaries stay fused inside the compiled program."""

    __slots__ = ("call", "idx", "__weakref__")

    def __init__(self, call, idx):
        self.call = call
        self.idx = idx
        call.handles.add(self)

    @property
    def shape(self):
        return self.call.avals[self.idx].shape

    @property
    def dtype(self):
        return self.call.avals[self.idx].dtype

    @property
    def ndim(self):
        return len(self.shape)

    def force(self):
        if self.call.results is None:
            materialize(self)
        return self.call.results[self.idx]


def _aval_of(x):
    if isinstance(x, LazyOut):
        return jax.ShapeDtypeStruct(x.shape, x.dtype)
    if _is_scalar(x):
        return x
    return jax.ShapeDtypeStruct(tuple(x.shape), x.dtype)


# Both caches are LRU-bounded (settings.lazy_program_cache): stable
# workloads never evict (keys are structural, value changes don't grow
# them), but a pathological generator of structurally-unique graphs
# can't grow them without bound.
_eval_memo = collections.OrderedDict()


def _lru_put(cache, key, value, cap):
    cache[key] = value
    cache.move_to_end(key)
    while len(cache) > cap:
        cache.popitem(last=False)


def _out_avals(fn, args):
    key_parts = []
    for a in args:
        if isinstance(a, LazyOut) or not _is_scalar(a):
            key_parts.append((tuple(a.shape), np.dtype(a.dtype).name))
        else:
            key_parts.append(("s", type(a).__name__))
    key = (fn, tuple(key_parts))
    try:
        entry = _eval_memo[key]
        _eval_memo.move_to_end(key)
        return entry, key
    except (KeyError, TypeError):
        pass
    out = jax.eval_shape(fn, *[_aval_of(a) for a in args])
    single = not isinstance(out, (tuple, list))
    avals = (out,) if single else tuple(out)
    avals = tuple(jax.ShapeDtypeStruct(tuple(o.shape), o.dtype) for o in avals)
    entry = (avals, single)
    try:
        _lru_put(_eval_memo, key, entry, 8 * settings.lazy_program_cache)
    except TypeError:
        pass
    return entry, key


def enabled():
    return settings.lazy_batch


def apply(fn, *args):
    """Invoke kernel ``fn`` — deferred when lazy batching is on.

    Returns a LazyOut (or tuple of them for multi-output kernels); with
    lazy off, executes immediately and returns concrete arrays.
    """
    if not settings.lazy_batch:
        return fn(*args)
    depth = 1
    for a in args:
        if isinstance(a, LazyOut):
            if a.call.results is not None:
                continue
            depth = max(depth, a.call.depth + 1)
    if depth > settings.lazy_max_depth:
        # Bound program size: force deep operands to concrete leaves.
        args = tuple(
            a.force() if isinstance(a, LazyOut) else a for a in args
        )
        depth = 1
    (avals, single), _ = _out_avals(fn, args)
    graph_args = tuple(
        _Ref(a.call, a.idx) if isinstance(a, LazyOut) else a for a in args
    )
    call = LazyCall(fn, graph_args, avals, depth)
    for a in args:
        if isinstance(a, LazyOut) and a.call.results is None:
            a.call.consumers.add(call)
    if single:
        return LazyOut(call, 0)
    return tuple(LazyOut(call, i) for i in range(len(avals)))


def force(x):
    """Concrete jax value for ``x`` (no-op for non-lazy values)."""
    if isinstance(x, LazyOut):
        return x.force()
    return x


# structural key -> jitted graph executor (LRU, see _eval_memo note)
_compiled = collections.OrderedDict()

# Per-THREAD count of graph executions; the autodiff layer snapshots it
# around the traced function to detect host syncs inside (which sever
# the recorded DAG and would silently freeze values). Thread-local so a
# concurrent thread materializing unrelated arrays during a traced call
# cannot false-positive the purity guard (VERDICT r2 weak #6).
_tls = threading.local()


def materialize_count() -> int:
    return getattr(_tls, "count", 0)


def _trace(root: LazyOut):
    """Walk the unmaterialized DAG below ``root``.

    Returns (order, specs, leaves, leaf_pos, call_pos, key_of, seen):
    topological call order (parents after children), per-call argument
    specs (('c', call_pos, out_idx) | ('f', leaf_idx)), deduped concrete
    leaves, and structural-key fragments. Shared by ``materialize`` and
    the autodiff path (``program_for``).
    """
    order = []  # parents after children
    seen = set()
    leaves = []  # discovery order, deduped by id (duplicate jit args
    leaf_pos = {}  # would double-count HBM through this PJRT transport)
    key_of = {}  # id(call) -> structural key fragment

    def leaf_key(x):
        if _is_scalar(x):
            return ("s", type(x).__name__)
        return ("l", tuple(x.shape), np.dtype(x.dtype).name)

    def add_leaf(x):
        i = leaf_pos.get(id(x))
        if i is None:
            i = len(leaves)
            leaves.append(x)
            leaf_pos[id(x)] = i
        return i

    stack = [root.call]
    while stack:
        call = stack.pop()
        if id(call) in seen or call.results is not None:
            continue
        pending = [
            a.call
            for a in call.args
            if isinstance(a, _Ref)
            and a.call.results is None
            and id(a.call) not in seen
        ]
        if pending:
            stack.append(call)
            stack.extend(pending)
            continue
        seen.add(id(call))
        order.append(call)

    # Argument specs and the structural key.
    specs = []  # per call: list of ('c', call_pos, out_idx) | ('f', leaf_idx)
    call_pos = {}
    has_interior_constants = False
    for pos, call in enumerate(order):
        call_pos[id(call)] = pos
        spec = []
        frag = [call.fn]
        for a in call.args:
            if isinstance(a, _Ref) and a.call.results is None and id(
                a.call
            ) in call_pos:
                p = call_pos[id(a.call)]
                spec.append(("c", p, a.idx))
                frag.append(("c", p, a.idx))
            else:
                if isinstance(a, _Ref):
                    # An already-materialized intermediate folds in as a
                    # CONSTANT leaf — correct for materialize, but it
                    # hides dependencies from autodiff (see program_for).
                    a = a.call.results[a.idx]
                    has_interior_constants = True
                li = add_leaf(a)
                spec.append(("f", li))
                # The leaf INDEX must be part of the key: graphs that
                # differ only in which args share a leaf (dedup pattern)
                # have different specs and must not share an executor.
                frag.append(("f", li, leaf_key(a)))
        specs.append(spec)
        key_of[id(call)] = tuple(frag)
    return (order, specs, leaves, leaf_pos, call_pos, key_of, seen,
            has_interior_constants)


def cached_executor(key, builder, cache=None):
    """LRU-bounded executor lookup shared by materialize and autodiff."""
    cache = _compiled if cache is None else cache
    ex = cache.get(key)
    if ex is not None:
        cache.move_to_end(key)
        return ex
    ex = builder()
    _lru_put(cache, key, ex, settings.lazy_program_cache)
    return ex


def program_for(root: LazyOut, forbid_interior_constants: bool = False):
    """(run_root, leaves, leaf_pos, key) for the DAG below ``root``:
    ``run_root(*leaf_vals)`` is a PURE function of the concrete leaves
    returning root's single output — jax-transformable (grad/jvp/vmap),
    the hook the autodiff layer differentiates through.

    ``forbid_interior_constants=True`` (the autodiff setting) raises if
    any already-materialized intermediate was folded into a constant
    leaf — a gradient through such a graph would silently treat those
    values as constants (host syncs inside the traced function, sibling
    materializations, or chains past NUMS_TPU_LAZY_MAX_DEPTH cause
    this)."""
    if root.call.results is not None:
        raise ValueError(
            "root is already materialized — there is no pending graph "
            "to build a program from."
        )
    (order, specs, leaves, leaf_pos, call_pos, key_of, _,
     interior_consts) = _trace(root)
    if forbid_interior_constants and interior_consts:
        raise RuntimeError(
            "the recorded graph contains already-materialized "
            "intermediates (a host sync inside the function, a sibling "
            "materialization, or a chain past NUMS_TPU_LAZY_MAX_DEPTH); "
            "gradients would silently treat them as constants. Remove "
            "syncs from the traced function or raise the depth cap."
        )
    root_pos = call_pos[id(root.call)]
    fns = [c.fn for c in order]
    nouts = [len(c.avals) for c in order]
    root_idx = root.idx

    def run_root(*leaf_vals):
        vals = []
        for fn, nout, spec in zip(fns, nouts, specs):
            call_args = [
                vals[s[1]][s[2]] if s[0] == "c" else leaf_vals[s[1]]
                for s in spec
            ]
            out = fn(*call_args)
            vals.append((out,) if nout == 1 else tuple(out))
        return vals[root_pos][root_idx]

    key = (tuple(key_of[id(c)] for c in order), root_pos, root_idx)
    return run_root, leaves, leaf_pos, key


def materialize(root: LazyOut):
    """Compile + run the expression DAG below ``root`` as ONE program.

    Only SINK calls (calls whose outputs nothing in this graph consumes)
    plus the root get concrete results — interior values stay fused
    inside the program (returning them would force every intermediate to
    HBM and defeat fusion). An interior node separately held by a
    BlockArray re-materializes later with its own (cached) program.
    """
    if root.call.results is not None:
        return root.call.results[root.idx]

    (order, specs, leaves, leaf_pos, call_pos, key_of, seen,
     _interior) = _trace(root)

    # Store results for the root, every call some live BlockArray still
    # references, AND every call a pending consumer OUTSIDE this graph
    # references (a sibling root not being materialized now — without
    # storing, its later materialization would recompute the subtree).
    # Dead temporaries stay fused (never touch HBM).
    root_pos = call_pos[id(root.call)]

    def _externally_consumed(c):
        return any(
            cons.results is None and id(cons) not in seen
            for cons in c.consumers
        )

    out_positions = tuple(
        p for p, c in enumerate(order)
        if p == root_pos or len(c.handles) > 0 or _externally_consumed(c)
    )
    key = (tuple(key_of[id(c)] for c in order), out_positions)

    def build():
        fns = [c.fn for c in order]
        nouts = [len(c.avals) for c in order]

        def run(*leaf_vals):
            vals = []  # per call: tuple of outputs
            for fn, nout, spec in zip(fns, nouts, specs):
                call_args = [
                    vals[s[1]][s[2]] if s[0] == "c" else leaf_vals[s[1]]
                    for s in spec
                ]
                out = fn(*call_args)
                vals.append((out,) if nout == 1 else tuple(out))
            return tuple(vals[p] for p in out_positions)

        return jax.jit(run)

    executor = cached_executor(key, build)
    _tls.count = materialize_count() + 1
    results = executor(*leaves)
    for p, res in zip(out_positions, results):
        order[p].results = tuple(res)
        # Results supersede args: drop them so upstream leaf buffers (and
        # calls) are released instead of pinned for the handle's lifetime.
        order[p].args = ()
    return root.call.results[root.idx]
