"""One-hot-matmul row gathers with a residual-free VJP.

The tables this framework gathers from per ray (primitive params, material
columns, solid-texture colors) are small: tens to thousands of rows.
``one_hot(idx) @ table`` is a dense [N, K] x [K, C] contraction at HIGHEST
precision, with the ``iota == idx`` compare fused into the matmul operand so
the one-hot is never materialized; its VJP is another dense contraction
instead of a scatter-add. Whether this beats ``jnp.take`` on the GPU is an
open question (ROADMAP A5).

Autodiff: the one-hot is an *operand* of the matmul, so plain autodiff would
SAVE the logical [N, K] array as a VJP residual (8.4 GB per gather at 2.09M
rays x 1002 rows). :func:`onehot_gather` is therefore wrapped in
``jax.checkpoint``: the VJP residuals shrink to the gather's *inputs* (the
[N] int32 index and the small table), the backward pass rebuilds the one-hot
compare on the fly, and — unlike a hand-written custom_vjp — the standard
transpose machinery still inserts the automatic psum for replicated table
cotangents under shard_map, so the sharded fit path keeps its exact gradient
semantics. Residual cost drops from O(N*K) to O(N) per gather.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

Array = jnp.ndarray

#: one-hot gather row cutoff: above it the per-gather contraction costs
#: more than a plain take.
ONE_HOT_MAX_ROWS = 4096

#: logical [N, K] cap — a flop guard (nothing is materialized or saved):
#: 2^33 bounds the per-gather contraction at ~N*K*C ~ 1e11 MACs.
#: Million-row tables (config 5's prim table) stay on the take path.
ONE_HOT_MAX_ELEMS = 1 << 33

#: integer/bool columns roundtrip through the f32 matmul; f32 represents
#: integers exactly only below 2^24, so larger stored values would silently
#: corrupt. Checked statically for concrete tables in _check_int_exact.
INT_EXACT_MAX = 1 << 24


def _check_int_exact(t: Array) -> None:
    """Static guard for the int-through-f32 one-hot roundtrip.

    Raises if a *concrete* integer/bool table stores values the f32 matmul
    cannot represent exactly (|v| >= 2^24). Traced tables can't be value-
    checked; every integer table in this framework stores indices into
    scene-sized tables (< 2^24 by construction), and this assert catches a
    concrete violation at trace time before it silently corrupts.
    """
    if not (jnp.issubdtype(t.dtype, jnp.integer) or t.dtype == jnp.bool_):
        return
    if isinstance(t, jax.core.Tracer) or t.dtype == jnp.bool_:
        return
    v = np.asarray(t)
    if v.size and (np.abs(v).max() >= INT_EXACT_MAX):
        raise ValueError(
            f"gather one-hot roundtrip: int table holds values >= 2^24 "
            f"(max {np.abs(v).max()}); f32 matmul would corrupt them")


@jax.checkpoint
def onehot_gather(idx: Array, cat: Array) -> Array:
    """``cat[idx]`` for [N] int idx and [K, C] float cat via one-hot matmul.

    HIGHEST precision: a lower-precision matmul (bf16 operands, or TF32
    on a GPU) would round the float columns (0.6 -> 0.6015625 in bf16);
    at HIGHEST one-hot selection is exact. ``jax.checkpoint`` keeps the
    [N, K] one-hot out of the VJP residuals (see module docstring).
    """
    k = cat.shape[0]
    oh = (idx[:, None] == jax.lax.iota(jnp.int32, k)[None, :]).astype(
        cat.dtype)
    return jnp.matmul(oh, cat, precision=jax.lax.Precision.HIGHEST)


@jax.checkpoint
def _onehot_gather_pair(idx: Array, grad_tab: Array, disc_tab: Array):
    """One shared one-hot, two matmuls: differentiable rows + stop-grad
    flag rows. The [N, K] operand is generated ONCE per autodiff direction
    (separate checkpointed gathers would each rebuild it), and the flag dot
    contributes no transpose work to the VJP."""
    k = grad_tab.shape[0]
    oh = (idx[:, None] == jax.lax.iota(jnp.int32, k)[None, :]).astype(
        grad_tab.dtype)
    g = jnp.matmul(oh, grad_tab, precision=jax.lax.Precision.HIGHEST)
    d = jnp.matmul(jax.lax.stop_gradient(oh),
                   jax.lax.stop_gradient(disc_tab),
                   precision=jax.lax.Precision.HIGHEST)
    return g, d


def gather_rows_pair(grad_tab: Array, disc_tab: Array, idx: Array):
    """``(grad_tab[idx], stop_grad(disc_tab)[idx])`` for [K, C] tables and
    [N] int idx — one-hot matmuls sharing the one-hot operand for small K,
    jnp.take otherwise."""
    k = grad_tab.shape[0]
    n = math.prod(idx.shape) if idx.shape else 1
    flat = idx.reshape(-1).astype(jnp.int32)
    if k > ONE_HOT_MAX_ROWS or n * k > ONE_HOT_MAX_ELEMS:
        return (jnp.take(grad_tab, flat, axis=0).reshape(
                    *idx.shape, grad_tab.shape[1]),
                jnp.take(jax.lax.stop_gradient(disc_tab), flat,
                         axis=0).reshape(*idx.shape, disc_tab.shape[1]))
    g, d = _onehot_gather_pair(flat, grad_tab, disc_tab)
    return (g.reshape(*idx.shape, grad_tab.shape[1]),
            d.reshape(*idx.shape, disc_tab.shape[1]))


def gather_rows(table: Array, idx: Array) -> Array:
    """``table[idx]`` for a [K, C...] table and [N] int idx -> [N, C...].

    One-hot matmul for small K (residual-free VJP), jnp.take otherwise.
    """
    k = table.shape[0]
    if k == 0:
        raise ValueError("empty table")
    n = math.prod(idx.shape) if idx.shape else 1
    if k > ONE_HOT_MAX_ROWS or n * k > ONE_HOT_MAX_ELEMS or table.ndim > 2:
        return jnp.take(table, idx, axis=0)
    tab2 = table[:, None] if table.ndim == 1 else table
    flat = idx.reshape(-1).astype(jnp.int32)
    out = onehot_gather(flat, tab2)
    out = out.reshape(*idx.shape, tab2.shape[1])
    return out[..., 0] if table.ndim == 1 else out


def gather_cols(idx: Array, *tables: Array) -> tuple:
    """Gather the same [N] idx from several [K]/[K,C] tables, sharing the
    one-hot operand so XLA computes it once."""
    if not tables:
        return ()
    k = tables[0].shape[0]
    n = math.prod(idx.shape) if idx.shape else 1
    if k > ONE_HOT_MAX_ROWS or n * k > ONE_HOT_MAX_ELEMS:
        return tuple(jnp.take(t, idx, axis=0) for t in tables)
    # concatenate as columns -> single matmul -> split
    cols = []
    widths = []
    for t in tables:
        _check_int_exact(t)
        t2 = t[:, None] if t.ndim == 1 else t
        cols.append(t2.astype(jnp.float32))
        widths.append(t2.shape[1])
    cat = jnp.concatenate(cols, axis=1)                    # [K, sum]
    out = onehot_gather(idx.reshape(-1).astype(jnp.int32), cat)
    out = out.reshape(*idx.shape, cat.shape[1])
    res = []
    off = 0
    for t, w in zip(tables, widths):
        piece = out[..., off:off + w]
        off += w
        if t.ndim == 1:
            piece = piece[..., 0]
        if jnp.issubdtype(t.dtype, jnp.integer) or t.dtype == jnp.bool_:
            piece = jnp.round(piece).astype(t.dtype)
        else:
            piece = piece.astype(t.dtype)
        res.append(piece)
    return tuple(res)
