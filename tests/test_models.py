"""Model-level tests: the functional DSTD-GCN against the fixture recorded
from the last flax implementation, tree layout, and the model knobs
(compute dtype, flat pair layout, grouped aggregation, remat)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dstdgcn_tpu.models import DSTDGCN, get_model
from dstdgcn_tpu.models.layers import DSTDGC
from dstdgcn_tpu.ops import dstd as oracle

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "model_fixture.npz")
CASES = [(name, layout, v) for name in ("dstdgcn", "dstdgcn_fast")
         for layout, v in (("h36m", 22), ("cmu", 25), ("3dpw", 23))]
CASE_IDS = [f"{n}_{l}" for n, l, _ in CASES]
WIDTHS = dict(input_channels=6, input_time_frame=4, output_time_frame=4,
              st_gcnn_dropout=0.0, num_feature=4, num_layers=1)
TOL = 1e-6


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as z:
        return {k: z[k] for k in z.files}


def _unpack(fx, key):
    """Rebuild a nested dict from a packed vector + ``path|shape`` index."""
    flat, out, o = fx[key], {}, 0
    for entry in fx[key + "_index"]:
        path, shape = str(entry).split("|")
        shape = tuple(int(s) for s in shape.split(",")) if shape else ()
        n = int(np.prod(shape))
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(flat[o:o + n].reshape(shape))
        o += n
    return out


def _case(fx, name, layout, v):
    model = get_model(name, **{name: dict(WIDTHS, joints_to_consider=v,
                                          layout=layout)})
    case = f"{name}_{layout}"
    variables = {"params": _unpack(fx, f"{case}/params"),
                 "batch_stats": _unpack(fx, f"{case}/batch_stats")}
    return model, variables, jnp.asarray(fx[f"{case}/x"]), case


def _close(got, want):
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                                   atol=TOL, err_msg=jax.tree_util.keystr(
                                       path))


@pytest.mark.parametrize("name,layout,v", CASES, ids=CASE_IDS)
def test_eval_forward_matches_flax_fixture(fixture, name, layout, v):
    model, variables, x, case = _case(fixture, name, layout, v)
    with jax.default_matmul_precision("highest"):
        out, stats = model.apply(variables, x, train=False)
    _close(out, fixture[f"{case}/eval_out"])
    _close(stats, variables["batch_stats"])      # eval leaves stats alone


@pytest.mark.parametrize("name,layout,v", CASES, ids=CASE_IDS)
def test_train_forward_matches_flax_fixture(fixture, name, layout, v):
    """Train mode, dropout 0: output and the BatchNorm statistic update."""
    model, variables, x, case = _case(fixture, name, layout, v)
    with jax.default_matmul_precision("highest"):
        out, stats = model.apply(variables, x, train=True)
    _close(out, fixture[f"{case}/train_out"])
    want = _unpack(fixture, f"{case}/train_stats")
    assert jax.tree.structure(stats) == jax.tree.structure(want)
    _close(stats, want)


@pytest.mark.parametrize("name,layout,v", CASES, ids=CASE_IDS)
def test_gradients_match_flax_fixture(fixture, name, layout, v):
    model, variables, x, case = _case(fixture, name, layout, v)

    def loss(params):
        out, _ = model.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             x, train=True)
        return jnp.mean(jnp.sin(out))

    with jax.default_matmul_precision("highest"):
        grads = jax.grad(loss)(variables["params"])
    want = _unpack(fixture, f"{case}/grads")
    assert jax.tree.structure(grads) == jax.tree.structure(want)
    _close(grads, want)


@pytest.mark.parametrize("name,layout,v", CASES, ids=CASE_IDS)
def test_init_tree_paths_and_shapes_match_fixture(fixture, name, layout, v):
    model, variables, x, _ = _case(fixture, name, layout, v)
    init = model.init(jax.random.key(0), x)
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)  # noqa
    assert shapes(init["params"]) == shapes(variables["params"])
    assert shapes(init["batch_stats"]) == shapes(variables["batch_stats"])


@pytest.mark.parametrize("config,count", [
    ("configs/dstdgcn_h36m.yaml", 173999),
    ("configs/dstdgcn_cmu.yaml", 184970),
    ("configs/dstdgcn_3dpw.yaml", 190767),
])
def test_full_width_parameter_count(config, count):
    from dstdgcn_tpu.utils.config import get_config

    cfg = get_config(os.path.join(os.path.dirname(__file__), "..", config))
    opts = dict(cfg["model"])
    model = get_model(opts.pop("name"), **opts)
    x = jax.ShapeDtypeStruct(
        (1, model.time_dim, model.joints_to_consider, 3), jnp.float32)
    params = jax.eval_shape(lambda: model.init(jax.random.key(0), x))
    assert sum(l.size for l in jax.tree.leaves(params["params"])) == count


def test_train_dropout_needs_key():
    model = DSTDGCN(input_time_frame=2, output_time_frame=2,
                    num_feature=4, num_layers=1, st_gcnn_dropout=0.5)
    x = jnp.ones((2, 4, 22, 3), jnp.float32)
    variables = model.init(jax.random.key(0), x)
    with pytest.raises(ValueError, match="PRNG key"):
        model.apply(variables, x, train=True)
    a, _ = model.apply(variables, x, train=True, key=jax.random.key(1))
    b, _ = model.apply(variables, x, train=True, key=jax.random.key(2))
    assert not np.allclose(np.asarray(a), np.asarray(b))


def test_input_shape_is_checked():
    model = DSTDGCN(input_time_frame=2, output_time_frame=2, num_feature=4,
                    num_layers=1)
    with pytest.raises(ValueError, match="does not match"):
        model.init(jax.random.key(0), jnp.ones((1, 5, 22, 3)))


# -- knobs -----------------------------------------------------------------

SMALL = dict(input_channels=6, input_time_frame=4, output_time_frame=4,
             st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=8,
             num_layers=1, layout="h36m")


def _weights(rng, k, cin, co, red, ref):
    mk = lambda *s: jnp.asarray(rng.randn(*s).astype(np.float32) * 0.3)  # noqa
    return dict(wf=mk(k, cin, co), bf=mk(k, co), wm1=mk(k, cin, red),
                bm1=mk(k, red), wm2=mk(k, cin, red), bm2=mk(k, red),
                wrm=mk(k, red, ref, ref), brm=mk(k, ref))


def test_compute_dtype_bf16_close_to_f32():
    """bf16 compute path stays within mixed-precision tolerance of f32."""
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(2, 8, 22, 3).astype(np.float32))
    m32 = DSTDGCN(**SMALL)
    variables = m32.init(jax.random.key(0), x)
    y32, _ = m32.apply(variables, x)
    m16 = DSTDGCN(**SMALL, compute_dtype="bfloat16")
    y16, _ = m16.apply(variables, x)
    err = float(jnp.abs(y32 - y16).max() / (jnp.abs(y32).max() + 1e-9))
    assert err < 3e-2, err
    # gradients flow through the bf16 path
    g = jax.grad(lambda p: jnp.sum(m16.apply(
        {"params": p, "batch_stats": variables["batch_stats"]}, x)[0] ** 2))(
            variables["params"])
    assert all(np.isfinite(np.asarray(l)).all() for l in jax.tree.leaves(g))


@pytest.mark.parametrize("mode", ["spatial", "temporal"])
@pytest.mark.parametrize("agg", ["right", "left"])
def test_pair_flat_matches_grid(mode, agg):
    """Flat (P*P) pair layout is numerically identical to the grid
    formulation (incl. masked pairs and gradients)."""
    rng = np.random.RandomState(3)
    n, t, v, cin, co = 3, 6, 5, 4, 4
    k = 2 if mode == "spatial" else 1
    ref = t if mode == "spatial" else v
    p = v if mode == "spatial" else t
    x = jnp.asarray(rng.randn(n, t, v, cin), jnp.float32)
    base = jnp.asarray(rng.randn(k, p, p), jnp.float32) * 0.3
    alpha = jnp.asarray(0.7)
    w = _weights(rng, k, cin, co, 2, ref)
    mask = jnp.asarray((rng.rand(p, p) < 0.7).astype(np.float32))
    op = oracle.dstd_spatial if mode == "spatial" else oracle.dstd_temporal
    for m in (None, mask):
        want = op(x, base, alpha, **w, mask=m, agg=agg)
        got = op(x, base, alpha, **w, mask=m, agg=agg, pair_flat=True)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    g0 = jax.grad(lambda xx: jnp.sum(op(xx, base, alpha, **w, agg=agg) ** 2))(x)
    g1 = jax.grad(lambda xx: jnp.sum(
        op(xx, base, alpha, **w, agg=agg, pair_flat=True) ** 2))(x)
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g0),
                               rtol=1e-5, atol=1e-5)


def test_model_variant_knobs_match_baseline():
    """Model-level perf knobs (block-diagonal agg_group sizes, flat pair
    layout) are numerically equivalent to the plain path."""
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(2, 8, 22, 3), jnp.float32)
    m0 = DSTDGCN(**SMALL)
    variables = m0.init(jax.random.key(0), x)
    y0 = np.asarray(m0.apply(variables, x)[0])
    for knobs in (dict(agg_group_spatial=4, agg_group_temporal=3),
                  # non-divisor spatial group (T=8 % 3 != 0): exercises the
                  # frame-padding path of aggregate_spatial_grouped
                  dict(agg_group_spatial=3, agg_group_temporal=2),
                  dict(pair_flat="spatial", agg_group_temporal=3)):
        y1 = np.asarray(DSTDGCN(**SMALL, **knobs).apply(variables, x)[0])
        assert np.abs(y1 - y0).max() < 1e-3 * max(np.abs(y0).max(), 1.0), \
            knobs


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_matches_no_remat(remat):
    """DSTDGC(remat=...) — jax.checkpoint around the op — reproduces the
    non-remat outputs AND gradients."""
    rng = np.random.RandomState(7)
    n, t, v, cin, co = 3, 6, 5, 4, 4
    x = jnp.asarray(rng.randn(n, t, v, cin), jnp.float32)
    base = jnp.asarray(rng.randn(2, v, v), jnp.float32) * 0.3
    alpha = jnp.asarray(0.7)
    mk = lambda r: DSTDGC(out_channels=co, ref_len=t, num_kernels=2,  # noqa
                          mode="spatial", remat=r)
    params = mk(False).init(jax.random.key(0), cin)

    def loss(m, p, xx):
        return jnp.sum(jnp.sin(m.apply(p, xx, base, alpha)))

    y0 = np.asarray(mk(False).apply(params, x, base, alpha))
    y1 = np.asarray(mk(remat).apply(params, x, base, alpha))
    np.testing.assert_allclose(y1, y0, rtol=1e-6, atol=1e-6)
    g0 = jax.grad(lambda p, xx: loss(mk(False), p, xx),
                  argnums=(0, 1))(params, x)
    g1 = jax.grad(lambda p, xx: loss(mk(remat), p, xx),
                  argnums=(0, 1))(params, x)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g0)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_model_remat_knob_matches_baseline():
    """The model-level remat knob (plumbed through STGCNNLayer/DSTDGCB) is
    a pure gradient-checkpointing choice: train-mode loss and parameter
    gradients match the non-remat model."""
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.randn(2, 8, 22, 3), jnp.float32)
    m0, m1 = DSTDGCN(**SMALL), DSTDGCN(**SMALL, remat=True)
    variables = m0.init(jax.random.key(0), x)

    def loss(m, params):
        out, _ = m.apply({"params": params,
                          "batch_stats": variables["batch_stats"]}, x,
                         train=True)
        return jnp.sum(out ** 2)

    l0, g0 = jax.value_and_grad(lambda p: loss(m0, p))(variables["params"])
    l1, g1 = jax.value_and_grad(lambda p: loss(m1, p))(variables["params"])
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(g1), jax.tree.leaves(g0)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_dstdgc_rejects_unknown_pair_flat():
    with pytest.raises(ValueError, match="pair_flat"):
        DSTDGC(out_channels=4, ref_len=4, pair_flat="both")
