"""Multi-device tests on the virtual 8-device CPU mesh.

Validates that (a) the explicit shard_map edge-partitioned DSTD ops match
the single-device oracle, and (b) a GSPMD-sharded train step (data x graph
mesh) reproduces single-device results.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from dstdgcn_tpu.ops import dstd as ops
from dstdgcn_tpu.parallel import (activation_sharding_context, make_mesh,
                                  dstd_spatial_edge_partitioned,
                                  dstd_temporal_edge_partitioned)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _weights(rng, k, cin, co, red, ref):
    return dict(
        wf=jnp.asarray(rng.randn(k, cin, co), jnp.float32) * 0.2,
        bf=jnp.asarray(rng.randn(k, co), jnp.float32) * 0.1,
        wm1=jnp.asarray(rng.randn(k, cin, red), jnp.float32) * 0.2,
        bm1=jnp.asarray(rng.randn(k, red), jnp.float32) * 0.1,
        wm2=jnp.asarray(rng.randn(k, cin, red), jnp.float32) * 0.2,
        bm2=jnp.asarray(rng.randn(k, red), jnp.float32) * 0.1,
        wrm=jnp.asarray(rng.randn(k, red, ref, ref), jnp.float32) * 0.2,
        brm=jnp.asarray(rng.randn(k, ref), jnp.float32) * 0.1,
    )


@pytest.mark.parametrize("graph_size", [2, 4])
def test_spatial_edge_partitioned_matches_oracle(graph_size):
    mesh = make_mesh(graph=graph_size)
    rng = np.random.RandomState(0)
    n, t, v, cin, co, k = 3, 7, 8, 6, 5, 2
    x = jnp.asarray(rng.randn(n, t, v, cin), jnp.float32)
    base = jnp.asarray(rng.randn(k, v, v), jnp.float32) * 0.3
    alpha = jnp.asarray(0.7)
    w = _weights(rng, k, cin, co, 2, t)
    want = ops.dstd_spatial(x, base, alpha, **w)
    got = dstd_spatial_edge_partitioned(mesh, x, base, alpha, *[
        w[n_] for n_ in
        ["wf", "bf", "wm1", "bm1", "wm2", "bm2", "wrm", "brm"]])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("graph_size", [2, 4])
def test_spatial_ring_matches_oracle(graph_size):
    """Ring-pipelined (ppermute-overlapped) spatial op vs the oracle —
    every (source, destination) pair visited exactly once across rounds."""
    from dstdgcn_tpu.parallel import dstd_spatial_ring

    mesh = make_mesh(graph=graph_size)
    rng = np.random.RandomState(4)
    n, t, v, cin, co, k = 3, 7, 8, 6, 5, 2
    x = jnp.asarray(rng.randn(n, t, v, cin), jnp.float32)
    base = jnp.asarray(rng.randn(k, v, v), jnp.float32) * 0.3
    alpha = jnp.asarray(0.7)
    w = _weights(rng, k, cin, co, 2, t)
    want = ops.dstd_spatial(x, base, alpha, **w)
    got = dstd_spatial_ring(mesh, x, base, alpha, *[
        w[n_] for n_ in
        ["wf", "bf", "wm1", "bm1", "wm2", "bm2", "wrm", "brm"]])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("graph_size", [2, 4])
def test_temporal_edge_partitioned_matches_oracle(graph_size):
    mesh = make_mesh(graph=graph_size)
    rng = np.random.RandomState(1)
    n, t, v, cin, co, k = 3, 6, 8, 5, 5, 1
    x = jnp.asarray(rng.randn(n, t, v, cin), jnp.float32)
    base = jnp.asarray(rng.randn(k, t, t), jnp.float32) * 0.3
    alpha = jnp.asarray(0.5)
    w = _weights(rng, k, cin, co, 2, v)
    want = ops.dstd_temporal(x, base, alpha, **w)
    got = dstd_temporal_edge_partitioned(mesh, x, base, alpha, *[
        w[n_] for n_ in
        ["wf", "bf", "wm1", "bm1", "wm2", "bm2", "wrm", "brm"]])
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_sharded_train_step_matches_single_device():
    """Full jitted train step under a (data=4, graph=2) mesh must reproduce
    the unsharded step (same global batch, same update)."""
    from dstdgcn_tpu.engine import PredictionEngine
    from dstdgcn_tpu.models import DSTDGCN

    cfg = dict(learn=dict(opt="adam", lr=1e-3, weight_decay=0, gamma=0.9,
                          step_size=5),
               loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
               use_weight=False, inverse=True, max_iter=-1)
    model = DSTDGCN(input_channels=6, input_time_frame=4,
                    output_time_frame=4, st_gcnn_dropout=0.0,
                    joints_to_consider=22, num_feature=8, num_layers=1,
                    layout="h36m")
    rng = np.random.RandomState(0)
    batch = rng.randn(8, 8, 66).astype(np.float32)
    batch_inv = batch[:, ::-1].copy()
    targets = rng.randn(8, 8, 66).astype(np.float32)

    def run(mesh):
        eng = PredictionEngine(dict(cfg), model)
        eng.init(batch[:1], seed=0)
        step = eng._build_train_step(None, None, None)
        with activation_sharding_context(mesh):
            if mesh is not None:
                sh = NamedSharding(mesh, P("data"))
                args = [jax.device_put(jnp.asarray(a), sh)
                        for a in (batch, batch_inv, targets)]
            else:
                args = [jnp.asarray(a) for a in (batch, batch_inv, targets)]
            state, losses = step(eng.state, *args, jnp.asarray(1e-3))
        return eng, state, losses

    eng0, state0, losses0 = run(None)
    mesh = make_mesh(data=4, graph=2)
    eng1, state1, losses1 = run(mesh)
    for name in losses0:
        np.testing.assert_allclose(float(losses0[name]),
                                   float(losses1[name]), rtol=1e-4)
    # compare the Adam first-moment (== scaled gradient) rather than params:
    # first-step Adam turns near-zero gradients into +-lr sign flips under
    # fp noise, which is not a correctness signal
    mu0 = jax.tree.leaves(state0.opt_state)[1]  # inner adam mu pytree leaf 0
    flat0 = jax.tree.leaves(state0.opt_state)
    flat1 = jax.tree.leaves(state1.opt_state)
    for a, b in zip(flat0, flat1):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f" and a.size > 1:
            scale = np.abs(a).max()
            assert np.max(np.abs(a - b)) < max(2e-3 * scale, 1e-8)


def test_engine_mesh_plumbing_end_to_end():
    """Engine with mesh/data_sharding shards batches and trains (the path
    the `parallel:` config block drives through the runner)."""
    import jax
    import numpy as np
    from dstdgcn_tpu.engine import PredictionEngine
    from dstdgcn_tpu.models import DSTDGCN
    from dstdgcn_tpu.parallel import batch_sharding, make_mesh

    model = DSTDGCN(input_channels=6, input_time_frame=4,
                    output_time_frame=4, st_gcnn_dropout=0.0,
                    joints_to_consider=22, num_feature=8, num_layers=1,
                    layout="h36m")
    cfg = dict(learn=dict(opt="adam", lr=1e-3, weight_decay=0, gamma=0.9,
                          step_size=5),
               loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
               use_weight=False, inverse=True, max_iter=-1)
    mesh = make_mesh(data=4, graph=2)
    eng = PredictionEngine(cfg, model, mesh=mesh,
                           data_sharding=batch_sharding(mesh))
    rng = np.random.RandomState(0)
    inputs = rng.randn(8, 8, 66).astype(np.float32)
    targets = rng.randn(8, 8, 66).astype(np.float32)
    eng.init(inputs[:1], seed=0)

    class L:
        def __len__(self):
            return 2

        def __iter__(self):
            for i in range(2):
                b = slice(4 * i, 4 * i + 4)
                yield inputs[b], inputs[b, ::-1], targets[b], targets[b]

    loss = eng.train(L(), epoch=0)
    assert np.isfinite(loss)
    avg, per_frame = eng.test(L(), input_n=4, eval_frame=[1, 3],
                              dim_used=np.arange(66))
    assert np.isfinite(avg) and per_frame.shape == (2,)


def test_distributed_single_process_noop():
    from dstdgcn_tpu.parallel import distributed as dist
    # no config, no env -> single-process no-op
    assert dist.initialize(None) == (0, 1)
    assert dist.process_info() == (0, 1)
    # a distributed block without coordinator/num_processes/process_id is
    # an error: nothing on a GPU cluster tells JAX the topology
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize({"coordinator": "auto"})
    assert dist.process_info() == (0, 1)


def test_distributed_env_overrides_config(monkeypatch):
    """Per-process env vars must beat the config block: the documented
    launch sets DSTDGCN_COORDINATOR per process, and config-first
    resolution would shadow it."""
    import jax

    from dstdgcn_tpu.parallel import distributed as dist

    captured = {}

    def fake_init(**kw):
        captured.update(kw)

    monkeypatch.setattr(dist, "_INITIALIZED", False)
    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    monkeypatch.setenv("DSTDGCN_COORDINATOR", "envhost:9")
    monkeypatch.setenv("DSTDGCN_NUM_PROCESSES", "2")
    monkeypatch.setenv("DSTDGCN_PROCESS_ID", "1")
    dist.initialize({"coordinator": "auto", "num_processes": 8,
                     "process_id": 5})
    assert captured == {"coordinator_address": "envhost:9",
                        "num_processes": 2, "process_id": 1}
    monkeypatch.setattr(dist, "_INITIALIZED", False)


def test_loader_process_split_partitions_global_batch():
    from dstdgcn_tpu.data import Loader
    rng = np.random.RandomState(0)
    data = (rng.randn(40, 3).astype(np.float32),)
    full = Loader(data, 8, shuffle=True, seed=3, drop_last=True)
    shards = [Loader(data, 8, shuffle=True, seed=3, drop_last=True,
                     process_index=i, process_count=2) for i in range(2)]
    for l in (full, *shards):
        l.set_epoch(2)
    for (gb,), (s0,), (s1,) in zip(full, *shards):
        assert s0.shape[0] == s1.shape[0] == gb.shape[0] // 2
        # interleaved split reassembles the exact global batch
        merged = np.empty_like(gb)
        merged[0::2], merged[1::2] = s0, s1
        np.testing.assert_array_equal(merged, gb)


def test_make_global_batch_single_process_places_sharded():
    from dstdgcn_tpu.parallel import batch_sharding, make_global_batch
    mesh = make_mesh(graph=1)
    arrs = (np.arange(32, dtype=np.float32).reshape(8, 4),)
    (out,) = make_global_batch(arrs, batch_sharding(mesh))
    assert isinstance(out, jax.Array)
    np.testing.assert_array_equal(np.asarray(out), arrs[0])


def test_tensor_parallel_model_axis_matches_single_device():
    """Optional tensor parallelism (SURVEY §2.6 "TP"): a (data x model)
    mesh shards feature channels of the projection weights / BN vectors /
    activations; the sharded train step must reproduce the unsharded one
    (XLA inserts the row-parallel all-reduces)."""
    from dstdgcn_tpu.engine import PredictionEngine
    from dstdgcn_tpu.models import DSTDGCN
    from dstdgcn_tpu.parallel import param_sharding

    cfg = dict(learn=dict(opt="adam", lr=1e-3, weight_decay=0, gamma=0.9,
                          step_size=5),
               loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
               use_weight=False, inverse=True, max_iter=-1)
    model = DSTDGCN(input_channels=6, input_time_frame=4,
                    output_time_frame=4, st_gcnn_dropout=0.0,
                    joints_to_consider=22, num_feature=8, num_layers=1,
                    layout="h36m")
    rng = np.random.RandomState(5)
    batch = rng.randn(8, 8, 66).astype(np.float32)
    batch_inv = batch[:, ::-1].copy()
    targets = rng.randn(8, 8, 66).astype(np.float32)

    def run(mesh):
        eng = PredictionEngine(dict(cfg), model,
                               data_sharding=(None if mesh is None else
                                              NamedSharding(mesh, P("data"))))
        eng.mesh = mesh
        eng.init(batch[:1], seed=0)
        step = eng._build_train_step(None, None, None)
        with activation_sharding_context(mesh):
            if mesh is not None:
                sh = NamedSharding(mesh, P("data"))
                args = [jax.device_put(jnp.asarray(a), sh)
                        for a in (batch, batch_inv, targets)]
            else:
                args = [jnp.asarray(a) for a in (batch, batch_inv, targets)]
            state, losses = step(eng.state, *args, jnp.asarray(1e-3))
        return eng, state, losses

    eng0, state0, losses0 = run(None)
    mesh = make_mesh(data=2, graph=1, model=4)
    # the TP rule actually shards something (wf last dim 8 over model=4)
    sh = param_sharding(mesh, {"wf": jnp.zeros((2, 8, 8))})
    assert "model" in str(sh["wf"].spec)
    eng1, state1, losses1 = run(mesh)
    for name in losses0:
        np.testing.assert_allclose(float(losses0[name]),
                                   float(losses1[name]), rtol=1e-4)
    for a, b in zip(jax.tree.leaves(state0.opt_state),
                    jax.tree.leaves(state1.opt_state)):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind == "f" and a.size > 1:
            scale = np.abs(a).max()
            assert np.max(np.abs(a - b)) < max(2e-3 * scale, 1e-8)
