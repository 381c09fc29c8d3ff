"""Functional DSTD-GC operators (jnp oracle implementations).

These are the semantic ground truth for the framework's compute path — pure
functions over channels-last ``(N, T, V, C)`` features.  The math matches the
reference PyTorch unit (``/root/reference/model/dstdgcn.py:53-94``) but is
re-expressed for XLA:

  * channels-last layout keeps C on the minor dimension;
  * the per-kernel Python loop of the reference block becomes a stacked
    kernel axis inside one contraction;
  * the pairwise-difference "constrained correlation" (an SDDMM-style
    all-pairs score) and the frame/joint mixing are einsums XLA lowers to
    batched matrix products.

They are also the plain reference any hand-written kernel is tested
against.

Shape glossary
--------------
N batch, T frames, V joints, C channels, R reduction channels (2), K number
of stacked graph kernels (2 spatial / 1 temporal).

Weight layouts (channels-last dense kernels):
  wf  (K, C_in, C_out), bf (K, C_out)        feature transform
  wm1 (K, C_in, R),     bm1 (K, R)           correlation query proj
  wm2 (K, C_in, R),     bm2 (K, R)           correlation key proj
  wrm spatial  (K, R, T, T),  brm (K, T)     frame-mixing of pair scores
  wrm temporal (K, R, V, V),  brm (K, V)     joint-mixing of pair scores

``wrm[k, r, s, t]`` corresponds to the reference 1x1 conv weight
``conv_rm.weight[t, r*T + s]`` (dstdgcn.py:68,86).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "dyn_adjacency_spatial",
    "dyn_adjacency_temporal",
    "aggregate_spatial",
    "aggregate_temporal",
    "aggregate_spatial_grouped",
    "aggregate_temporal_grouped",
    "dstd_spatial",
    "dstd_temporal",
    "sddmm_pairwise_tanh",
]


def _constrain(x: jnp.ndarray) -> jnp.ndarray:
    """Pin (N,T,V,C) activations to the mesh layout when one is active."""
    from ..parallel.mesh import constrain_activation
    return constrain_activation(x)


def _cast(x: jnp.ndarray, dtype) -> jnp.ndarray:
    return x if dtype is None else x.astype(dtype)


def _cast_dot(x: jnp.ndarray, dtype) -> jnp.ndarray:
    """Like _cast, but stays f32 on the CPU backend: XLA:CPU's DotThunk
    cannot execute bf16 x bf16 -> f32 contractions for some shapes."""
    if dtype is not None and jax.default_backend() == "cpu":
        return x.astype(jnp.float32)
    return _cast(x, dtype)


def _project(x: jnp.ndarray, w: jnp.ndarray, b: jnp.ndarray,
             dtype=None) -> jnp.ndarray:
    """(N,T,V,Ci) x (K,Ci,Co) -> (K,N,T,V,Co); one matmul per kernel.

    ``dtype`` (e.g. bfloat16) casts the matmul INPUTS only — accumulation
    stays float32 via preferred_element_type (mixed precision)."""
    y = jnp.einsum("ntvc,kcd->kntvd", _cast(x, dtype), _cast(w, dtype),
                   preferred_element_type=jnp.float32)
    return y + b[:, None, None, None, :]


def sddmm_pairwise_tanh(q: jnp.ndarray, k: jnp.ndarray,
                        mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """All-pairs constrained-correlation scores ``tanh(q_i - k_j)``.

    q, k: (..., P, R) over P nodes -> (..., R, P, P) scores.  The optional
    0/1 ``mask`` (P, P) restricts score computation to permitted pairs — the
    general "constrained SDDMM" surface, in dense form (a block-sparse
    kernel that skips fully-masked blocks is ROADMAP W2).
    """
    d = q[..., :, None, :] - k[..., None, :, :]       # (..., P, P, R)
    s = jnp.tanh(d)
    if mask is not None:
        s = s * mask[..., :, :, None]
    return jnp.moveaxis(s, -1, -3)                    # (..., R, P, P)


def dyn_adjacency_spatial(x: jnp.ndarray, wm1, bm1, wm2, bm2, wrm, brm,
                          mask: jnp.ndarray | None = None,
                          dtype=None) -> jnp.ndarray:
    """Dynamic per-frame joint adjacency adjustment.

    x (N,T,V,C) -> (K,N,T,V,V).  Reference dstdgcn.py:82-86: project to R
    channels, all-pairs tanh difference over joints, then mix the (R, T)
    score channels into each output frame with ``wrm``.

    The projections are emitted as (K, N, R*T, V) with joints on the minor
    dim, so the pairwise broadcast runs over contiguous joints instead of
    over an R=2 minor dim.
    """
    kk, rr = wm1.shape[0], wm1.shape[-1]
    # one matmul for q AND k (wm1|wm2 concatenated on the R axis): halves
    # the passes over x; output columns are independent so the results are
    # bitwise those of separate projections
    qk = jnp.einsum("ntvc,kcr->knrtv", _cast(x, dtype),
                    _cast(jnp.concatenate([wm1, wm2], axis=-1), dtype),
                    preferred_element_type=jnp.float32) \
        + jnp.concatenate([bm1, bm2], axis=-1)[:, None, :, None, None]
    q, k = qk[:, :, :rr], qk[:, :, rr:]
    nn, tt, vv = x.shape[0], x.shape[1], x.shape[2]
    q = _cast(q, dtype).reshape(kk, nn, rr * tt, vv)
    k = _cast(k, dtype).reshape(kk, nn, rr * tt, vv)
    s = jnp.tanh(q[..., :, None] - k[..., None, :])    # (K,N,R*T,V,W)
    if mask is not None:
        s = s * mask
    dyn = jnp.einsum("knsvw,kst->kntvw", _cast_dot(s, dtype),
                     _cast_dot(wrm.reshape(kk, rr * tt, tt), dtype),
                     preferred_element_type=jnp.float32)
    return dyn + brm[:, None, :, None, None]


def dyn_adjacency_temporal(x: jnp.ndarray, wm1, bm1, wm2, bm2, wrm, brm,
                           mask: jnp.ndarray | None = None,
                           dtype=None) -> jnp.ndarray:
    """Dynamic per-joint frame adjacency adjustment.

    x (N,T,V,C) -> (K,N,V,T,T).  Reference dstdgcn.py:89-92: pairwise tanh
    over frames, mixing the (R, V) score channels into each output joint.

    Projections are emitted frames-minor as (K, N, R*V, T) — see the
    spatial variant for why.
    """
    kk, rr = wm1.shape[0], wm1.shape[-1]
    # q AND k in one matmul (see dyn_adjacency_spatial)
    qk = jnp.einsum("ntvc,kcr->knrvt", _cast(x, dtype),
                    _cast(jnp.concatenate([wm1, wm2], axis=-1), dtype),
                    preferred_element_type=jnp.float32) \
        + jnp.concatenate([bm1, bm2], axis=-1)[:, None, :, None, None]
    q, k = qk[:, :, :rr], qk[:, :, rr:]
    nn, tt, vv = x.shape[0], x.shape[1], x.shape[2]
    q = _cast(q, dtype).reshape(kk, nn, rr * vv, tt)
    k = _cast(k, dtype).reshape(kk, nn, rr * vv, tt)
    s = jnp.tanh(q[..., :, None] - k[..., None, :])    # (K,N,R*V,T,U)
    if mask is not None:
        s = s * mask
    dyn = jnp.einsum("knstu,ksw->knwtu", _cast_dot(s, dtype),
                     _cast_dot(wrm.reshape(kk, rr * vv, vv), dtype),
                     preferred_element_type=jnp.float32)
    return dyn + brm[:, None, :, None, None]


def aggregate_spatial(xf: jnp.ndarray, adj: jnp.ndarray,
                      agg: str = "right", dtype=None) -> jnp.ndarray:
    """Per-frame dense SpMM over joints, summed over stacked kernels.

    xf (K,N,T,V,C), adj (K,N,T,V,V) -> (N,T,V,C).

    ``agg="right"`` (qualitative variant): out[n,t,w,c] = sum_{k,v}
    xf[k,n,t,v,c] * adj[k,n,t,v,w] (reference einsum "nctv,ntvw->nctw",
    dstdgcn.py:87).  ``agg="left"`` (fast variant): out[n,t,v,c] =
    sum_{k,w} adj[k,n,t,v,w] * xf[k,n,t,w,c] (``torch.matmul(xm, xf)``,
    dstdgcn_fast.py:125).
    """
    eq = "kntvc,kntvw->ntwc" if agg == "right" else "kntvw,kntwc->ntvc"
    a, b = (xf, adj) if agg == "right" else (adj, xf)
    return jnp.einsum(eq, _cast_dot(a, dtype), _cast_dot(b, dtype),
                      preferred_element_type=jnp.float32)


def aggregate_temporal(xf: jnp.ndarray, adj: jnp.ndarray,
                       agg: str = "right", dtype=None) -> jnp.ndarray:
    """Per-joint dense SpMM over frames, summed over stacked kernels.

    xf (K,N,T,V,C), adj (K,N,V,T,T) -> (N,T,V,C).

    ``agg="right"``: out[n,u,v,c] = sum_{k,t} xf[k,n,t,v,c] * adj[k,n,v,t,u]
    (reference einsum "nctv,nvtu->ncuv", dstdgcn.py:93).  ``agg="left"``:
    out[n,t,v,c] = sum_{k,u} adj[k,n,v,t,u] * xf[k,n,u,v,c]
    (dstdgcn_fast.py:145-146).
    """
    xf, adj = _cast_dot(xf, dtype), _cast_dot(adj, dtype)
    if agg == "right":
        return jnp.einsum("kntvc,knvtu->nuvc", xf, adj,
                          preferred_element_type=jnp.float32)
    return jnp.einsum("knvtu,knuvc->ntvc", adj, xf,
                      preferred_element_type=jnp.float32)


def _pad_axis(x: jnp.ndarray, axis: int, size: int) -> jnp.ndarray:
    pad = size - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return jnp.pad(x, widths)


def _block_diag_batch(adj: jnp.ndarray, g: int) -> jnp.ndarray:
    """(..., B, P, P) per-item adjacencies -> (..., B/g, g*P, g*P) batched
    block-diagonal matrices.

    A batched matmul with tiny M/K (P=22..40 joints or frames) issues one
    small product per batch item; packing ``g`` consecutive items into one
    block-diagonal matrix makes each product g*P wide, cutting the number
    of products by g at the cost of g x the adjacency bytes and FLOPs
    (multiplications by zero).  Semantics are exactly the per-item batched
    contraction (golden-tested vs :func:`aggregate_spatial` /
    :func:`aggregate_temporal`); whether it pays is measured per shape by
    ``bench.py --autotune``.
    """
    *lead, b, p, p2 = adj.shape
    assert p == p2 and b % g == 0, (adj.shape, g)
    a6 = adj.reshape(*lead, b // g, g, p, p)
    eye = jnp.eye(g, dtype=adj.dtype)
    bd = a6[..., :, :, None, :] * eye[:, None, :, None]
    return bd.reshape(*lead, b // g, g * p, g * p)


def _grouped_custom_vjp_enabled() -> bool:
    """Hand-derived backward for the grouped aggregations, off by default.

    It computes ``dadj`` per item (a C-contraction) instead of autodiff's
    full (g*P, g*P) block-diagonal cotangent masked back to the diagonal
    blocks.  ``DSTDGCN_GROUPED_AGG_VJP=1`` opts in; gradients are
    golden-tested (tests/test_grouped_vjp.py).  Its speed on the H100 is
    not measured.
    """
    import os
    return os.environ.get("DSTDGCN_GROUPED_AGG_VJP", "0") == "1"


def _agg_spatial_grouped_impl(xf, adj, g, agg, dtype):
    kk, nn, tt, vv, cc = xf.shape
    tp = -(-tt // g) * g
    xfp = _pad_axis(_cast_dot(xf, dtype), 2, tp)
    xfg = xfp.reshape(kk, nn, tp // g, g * vv, cc)
    bd = _block_diag_batch(_pad_axis(_cast_dot(adj, dtype), 2, tp), g)
    if agg == "right":
        out = jnp.einsum("knbvc,knbvw->nbwc", xfg, bd,
                         preferred_element_type=jnp.float32)
    else:
        out = jnp.einsum("knbvw,knbwc->nbvc", bd, xfg,
                         preferred_element_type=jnp.float32)
    return out.reshape(nn, tp, vv, cc)[:, :tt]


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def _agg_spatial_grouped_cv(xf, adj, g, agg, dtype):
    return _agg_spatial_grouped_impl(xf, adj, g, agg, dtype)


def _agg_spatial_grouped_cv_fwd(xf, adj, g, agg, dtype):
    return _agg_spatial_grouped_impl(xf, adj, g, agg, dtype), (xf, adj)


def _agg_spatial_grouped_cv_bwd(g, agg, dtype, res, dout):
    xf, adj = res
    kk, nn, tt, vv, cc = xf.shape
    tp = -(-tt // g) * g
    do = _cast_dot(dout, dtype)                        # (N,T,V,C)
    do_p = _pad_axis(do, 1, tp).reshape(nn, tp // g, g * vv, cc)
    bd = _block_diag_batch(_pad_axis(_cast_dot(adj, dtype), 2, tp), g)
    xfc = _cast_dot(xf, dtype)
    if agg == "right":
        # out[n,b,w,c] = sum_{k,v} xfg·bd  =>
        dxf_g = jnp.einsum("knbvw,nbwc->knbvc", bd, do_p,
                           preferred_element_type=jnp.float32)
        dadj = jnp.einsum("kntvc,ntwc->kntvw", xfc, do,
                          preferred_element_type=jnp.float32)
    else:
        # out[n,b,v,c] = sum_{k,w} bd·xfg  =>
        dxf_g = jnp.einsum("knbvw,nbvc->knbwc", bd, do_p,
                           preferred_element_type=jnp.float32)
        dadj = jnp.einsum("ntvc,kntwc->kntvw", do, xfc,
                          preferred_element_type=jnp.float32)
    dxf = dxf_g.reshape(kk, nn, tp, vv, cc)[:, :, :tt]
    return dxf.astype(xf.dtype), dadj.astype(adj.dtype)


_agg_spatial_grouped_cv.defvjp(_agg_spatial_grouped_cv_fwd,
                               _agg_spatial_grouped_cv_bwd)


def aggregate_spatial_grouped(xf: jnp.ndarray, adj: jnp.ndarray, g: int,
                              agg: str = "right", dtype=None) -> jnp.ndarray:
    """Frame-grouped block-diagonal variant of :func:`aggregate_spatial`.

    xf (K,N,T,V,C), adj (K,N,T,V,V) -> (N,T,V,C); ``g`` frames are packed
    per matmul, turning the per-(n,t) V x V aggregation into (g*V) x (g*V)
    block-diagonal matmuls.  T is zero-padded up to a
    multiple of ``g`` (zero adjacency blocks over zero features contribute
    nothing; the padded frames are sliced off) — so ``g`` need not divide
    T, e.g. g=4 on T=35.

    Backward: plain autodiff by default; a hand-derived VJP exists but
    measured slower (see :func:`_grouped_custom_vjp_enabled`).
    """
    if _grouped_custom_vjp_enabled():
        return _agg_spatial_grouped_cv(_cast_dot(xf, dtype),
                                       _cast_dot(adj, dtype), g, agg, dtype)
    return _agg_spatial_grouped_impl(xf, adj, g, agg, dtype)


def _agg_temporal_grouped_impl(xf, adj, g, agg, dtype):
    kk, nn, tt, vv, cc = xf.shape
    vp = -(-vv // g) * g
    xf_v = jnp.swapaxes(_cast_dot(xf, dtype), 2, 3)    # (K,N,V,T,C)
    xf_v = _pad_axis(xf_v, 2, vp).reshape(kk, nn, vp // g, g * tt, cc)
    bd = _block_diag_batch(_pad_axis(_cast_dot(adj, dtype), 2, vp), g)
    if agg == "right":
        out = jnp.einsum("knbtc,knbtu->nbuc", xf_v, bd,
                         preferred_element_type=jnp.float32)
    else:
        out = jnp.einsum("knbtu,knbuc->nbtc", bd, xf_v,
                         preferred_element_type=jnp.float32)
    out = out.reshape(nn, vp, tt, cc)[:, :vv]          # (N,V,T,C)
    return jnp.swapaxes(out, 1, 2)


@functools.partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def _agg_temporal_grouped_cv(xf, adj, g, agg, dtype):
    return _agg_temporal_grouped_impl(xf, adj, g, agg, dtype)


def _agg_temporal_grouped_cv_fwd(xf, adj, g, agg, dtype):
    return _agg_temporal_grouped_impl(xf, adj, g, agg, dtype), (xf, adj)


def _agg_temporal_grouped_cv_bwd(g, agg, dtype, res, dout):
    xf, adj = res
    kk, nn, tt, vv, cc = xf.shape
    vp = -(-vv // g) * g
    do_v = jnp.swapaxes(_cast_dot(dout, dtype), 1, 2)  # (N,V,T,C)
    do_p = _pad_axis(do_v, 1, vp).reshape(nn, vp // g, g * tt, cc)
    bd = _block_diag_batch(_pad_axis(_cast_dot(adj, dtype), 2, vp), g)
    xf_v = jnp.swapaxes(_cast_dot(xf, dtype), 2, 3)    # (K,N,V,T,C)
    if agg == "right":
        # out_v[n,b,u,c] = sum_{k,t} xf_v·bd  =>
        dxf_g = jnp.einsum("knbtu,nbuc->knbtc", bd, do_p,
                           preferred_element_type=jnp.float32)
        dadj = jnp.einsum("knvtc,nvuc->knvtu", xf_v, do_v,
                          preferred_element_type=jnp.float32)
    else:
        # out_v[n,b,t,c] = sum_{k,u} bd·xf_v  =>
        dxf_g = jnp.einsum("knbtu,nbtc->knbuc", bd, do_p,
                           preferred_element_type=jnp.float32)
        dadj = jnp.einsum("nvtc,knvuc->knvtu", do_v, xf_v,
                          preferred_element_type=jnp.float32)
    dxf_v = dxf_g.reshape(kk, nn, vp, tt, cc)[:, :, :vv]
    dxf = jnp.swapaxes(dxf_v, 2, 3)                    # (K,N,T,V,C)
    return dxf.astype(xf.dtype), dadj.astype(adj.dtype)


_agg_temporal_grouped_cv.defvjp(_agg_temporal_grouped_cv_fwd,
                                _agg_temporal_grouped_cv_bwd)


def aggregate_temporal_grouped(xf: jnp.ndarray, adj: jnp.ndarray, g: int,
                               agg: str = "right", dtype=None) -> jnp.ndarray:
    """Joint-grouped block-diagonal variant of :func:`aggregate_temporal`.

    xf (K,N,T,V,C), adj (K,N,V,T,T) -> (N,T,V,C); ``g`` joints are packed
    per matmul.  V is zero-padded up to a multiple of ``g`` (zero rows of
    the block-diagonal contribute nothing).

    Backward: plain autodiff by default; a hand-derived VJP exists but
    measured slower (see :func:`_grouped_custom_vjp_enabled`).
    """
    if _grouped_custom_vjp_enabled():
        return _agg_temporal_grouped_cv(_cast_dot(xf, dtype),
                                        _cast_dot(adj, dtype), g, agg,
                                        dtype)
    return _agg_temporal_grouped_impl(xf, adj, g, agg, dtype)


def _dyn_adjacency_flat(x, wm1, bm1, wm2, bm2, wrm, brm, mask, dtype,
                        pair: str) -> jnp.ndarray:
    """Shared flat-pair dynamic-adjacency core.

    ``pair="vv"`` (spatial): scores over joint pairs per source frame,
    mixed into output frames -> (K, N, T, V*V).
    ``pair="tt"`` (temporal): scores over frame pairs per source joint,
    mixed into output joints -> (K, N, V, T*T).

    The pair dim stays flat (V*V or T*T minor) through the score and
    mixing stages; only the final adjacency is reshaped to the pair grid
    before aggregation.  Semantics identical to the grid functions
    (golden-tested); its speed on the H100 is not measured.
    """
    kk, rr = wm1.shape[0], wm1.shape[-1]
    nn, tt, vv = x.shape[0], x.shape[1], x.shape[2]
    out_eq = "knsp,kst->kntp" if pair == "vv" else "knsp,ksw->knwp"
    lay = "knrtv" if pair == "vv" else "knrvt"
    qk = jnp.einsum(f"ntvc,kcr->{lay}", _cast(x, dtype),
                    _cast(jnp.concatenate([wm1, wm2], axis=-1), dtype),
                    preferred_element_type=jnp.float32) \
        + jnp.concatenate([bm1, bm2], axis=-1)[:, None, :, None, None]
    q, k = qk[:, :, :rr], qk[:, :, rr:]
    p = vv if pair == "vv" else tt
    ss = rr * (tt if pair == "vv" else vv)
    q = _cast(q, dtype).reshape(kk, nn, ss, p)
    k = _cast(k, dtype).reshape(kk, nn, ss, p)
    s = jnp.tanh(q[..., :, None] - k[..., None, :])    # (K,N,S,P,P)
    if mask is not None:
        s = s * mask
    s = s.reshape(kk, nn, ss, p * p)                   # flat pair dim
    wrm2 = wrm.reshape(kk, ss, wrm.shape[-1])
    dyn = jnp.einsum(out_eq, _cast_dot(s, dtype), _cast_dot(wrm2, dtype),
                     preferred_element_type=jnp.float32)
    return dyn + brm[:, None, :, None]                 # (K,N,To|Wo,P*P)


def dstd_spatial(x: jnp.ndarray, base_adj: jnp.ndarray, alpha: jnp.ndarray,
                 wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                 mask: jnp.ndarray | None = None,
                 agg: str = "right", dtype=None,
                 pair_flat: bool = False,
                 agg_group: int | None = None) -> jnp.ndarray:
    """Full spatial DSTD-GC over K stacked kernels.

    x (N,T,V,Ci), base_adj (K,V,V) static part -> (N,T,V,Co).
    effective adjacency = dyn * alpha + base (dstdgcn.py:86).
    ``dtype=jnp.bfloat16`` runs the contractions in mixed precision
    (bf16 inputs, f32 accumulation); params/outputs stay f32.
    ``pair_flat=True`` computes scores/dyn/adjacency-assembly in the flat
    (V*V)-flat layout (see _dyn_adjacency_flat) and reshapes to the pair
    grid only at the aggregation boundary.
    ``agg_group=g`` aggregates via frame-grouped block-diagonal matmuls
    (see :func:`aggregate_spatial_grouped`; T is padded to a multiple of g).
    """
    x = _constrain(x)
    nn, tt, vv = x.shape[0], x.shape[1], x.shape[2]
    kk = wm1.shape[0]
    xf = _cast(_project(x, wf, bf, dtype), dtype)     # (K,N,T,V,Co)
    if pair_flat:
        dynf = _dyn_adjacency_flat(x, wm1, bm1, wm2, bm2, wrm, brm,
                                   mask, dtype, "vv")
        adjf = _cast(dynf, dtype) * _cast(jnp.asarray(alpha), dtype) \
            + _cast(base_adj, dtype).reshape(kk, 1, 1, vv * vv)
        adj = adjf.reshape(kk, nn, tt, vv, vv)
    else:
        dyn = dyn_adjacency_spatial(x, wm1, bm1, wm2, bm2, wrm, brm,
                                    mask, dtype)
        # keep the adjacency in the compute dtype end-to-end: casting
        # inside aggregate instead would materialize it twice in HBM
        adj = _cast(dyn, dtype) * _cast(jnp.asarray(alpha), dtype) \
            + _cast(base_adj, dtype)[:, None, None, :, :]
    if agg_group is not None:
        out = aggregate_spatial_grouped(xf, adj, agg_group, agg, dtype)
    else:
        out = aggregate_spatial(xf, adj, agg, dtype)
    # mixed-precision activation flow: emit the compute dtype so chained
    # ops move half the HBM bytes (accumulation stayed f32 above)
    return _constrain(out if dtype is None else out.astype(dtype))


def dstd_temporal(x: jnp.ndarray, base_adj: jnp.ndarray, alpha: jnp.ndarray,
                  wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                  mask: jnp.ndarray | None = None,
                  agg: str = "right", dtype=None,
                  pair_flat: bool = False,
                  agg_group: int | None = None) -> jnp.ndarray:
    """Full temporal DSTD-GC over K stacked kernels.

    x (N,T,V,Ci), base_adj (K,T,T) static part -> (N,T,V,Co).
    ``pair_flat`` as in :func:`dstd_spatial`, with a (T*T)-flat pair dim.
    ``agg_group=g`` aggregates via joint-grouped block-diagonal matmuls
    (see :func:`aggregate_temporal_grouped`).
    """
    x = _constrain(x)
    nn, tt, vv = x.shape[0], x.shape[1], x.shape[2]
    kk = wm1.shape[0]
    xf = _cast(_project(x, wf, bf, dtype), dtype)     # (K,N,T,V,Co)
    if pair_flat:
        dynf = _dyn_adjacency_flat(x, wm1, bm1, wm2, bm2, wrm, brm,
                                   mask, dtype, "tt")
        adjf = _cast(dynf, dtype) * _cast(jnp.asarray(alpha), dtype) \
            + _cast(base_adj, dtype).reshape(kk, 1, 1, tt * tt)
        adj = adjf.reshape(kk, nn, vv, tt, tt)
    else:
        dyn = dyn_adjacency_temporal(x, wm1, bm1, wm2, bm2, wrm, brm, mask,
                                     dtype)
        adj = _cast(dyn, dtype) * _cast(jnp.asarray(alpha), dtype) \
            + _cast(base_adj, dtype)[:, None, None, :, :]
    if agg_group is not None:
        out = aggregate_temporal_grouped(xf, adj, agg_group, agg, dtype)
    else:
        out = aggregate_temporal(xf, adj, agg, dtype)
    return _constrain(out if dtype is None else out.astype(dtype))
