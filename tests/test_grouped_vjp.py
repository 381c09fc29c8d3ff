"""Hand-derived VJP of the grouped aggregations (ops/dstd.py).

XLA's autodiff of the block-diagonal grouped formulation materializes
the FULL (g*P, g*P) cotangent and masks it back to the diagonal blocks
— which motivated a hand-derived VJP computing ``dadj`` per item
(C-contraction) and ``dxf`` via the forward's block-diagonal trick.
The default is plain autodiff and the custom path is opt-in
(DSTDGCN_GROUPED_AGG_VJP=1).  These tests keep the opt-in path honest:
gradients must match BOTH oracles — autodiff of the ungrouped
aggregation and autodiff of the grouped implementation itself.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dstdgcn_tpu.ops import dstd as D

K, N, T, V, C = 2, 3, 7, 6, 8


@pytest.fixture
def arrs():
    rng = np.random.RandomState(0)
    return (jnp.asarray(rng.randn(K, N, T, V, C), jnp.float32),
            jnp.asarray(rng.randn(K, N, T, V, V), jnp.float32),
            jnp.asarray(rng.randn(K, N, V, T, T), jnp.float32))


def _grads(fn, *args):
    return jax.grad(lambda *a: (fn(*a) ** 2).sum(), argnums=(0, 1))(*args)


def _assert_close(got, want, tol=1e-5):
    for a, b in zip(want, got):
        err = float(jnp.abs(a - b).max() / (jnp.abs(a).max() + 1e-9))
        assert err < tol, err


@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("g", [1, 2, 3])
def test_spatial_grouped_vjp_matches_oracles(arrs, agg, g, monkeypatch):
    xf, adj, _ = arrs
    want = _grads(lambda a, b: D.aggregate_spatial(a, b, agg), xf, adj)
    got = _grads(lambda a, b: D.aggregate_spatial_grouped(a, b, g, agg),
                 xf, adj)
    _assert_close(got, want)
    # the opt-in custom-VJP path agrees too
    monkeypatch.setenv("DSTDGCN_GROUPED_AGG_VJP", "1")
    ref = _grads(lambda a, b: D.aggregate_spatial_grouped(a, b, g, agg),
                 xf, adj)
    _assert_close(got, ref)


@pytest.mark.parametrize("agg", ["right", "left"])
@pytest.mark.parametrize("g", [1, 2, 3])
def test_temporal_grouped_vjp_matches_oracles(arrs, agg, g, monkeypatch):
    xf, _, adj_t = arrs
    want = _grads(lambda a, b: D.aggregate_temporal(a, b, agg), xf, adj_t)
    got = _grads(lambda a, b: D.aggregate_temporal_grouped(a, b, g, agg),
                 xf, adj_t)
    _assert_close(got, want)
    monkeypatch.setenv("DSTDGCN_GROUPED_AGG_VJP", "1")
    ref = _grads(lambda a, b: D.aggregate_temporal_grouped(a, b, g, agg),
                 xf, adj_t)
    _assert_close(got, ref)


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16])
def test_full_op_gradient_with_custom_vjp(arrs, dtype, monkeypatch):
    """dstd_spatial end-to-end grads (through projections, scores,
    adjacency assembly AND the grouped aggregation) match the ungrouped
    path — with the custom VJP actually ENABLED, in both dtypes, so the
    opt-in path's cast chain stays correct (on the CPU backend bf16
    contractions degrade to f32 via _cast_dot, which still exercises the
    cast plumbing)."""
    monkeypatch.setenv("DSTDGCN_GROUPED_AGG_VJP", "1")
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(N, T, V, C), jnp.float32)
    mk = lambda *s: jnp.asarray(rng.randn(*s), jnp.float32) * 0.3
    wargs = (mk(K, V, V), jnp.asarray(0.5), mk(K, C, C), mk(K, C),
             mk(K, C, 2), mk(K, 2), mk(K, C, 2), mk(K, 2),
             mk(K, 2, T, T), mk(K, T))

    def loss(xx, group):
        return (D.dstd_spatial(xx, *wargs, agg_group=group,
                               dtype=dtype) ** 2).sum()

    g_base = jax.grad(loss)(x, None)
    g_cv = jax.grad(loss)(x, 3)
    err = float(jnp.abs(g_base - g_cv).max() / jnp.abs(g_base).max())
    assert err < (1e-5 if dtype is None else 3e-2)
