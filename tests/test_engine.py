"""Engine behavior tests: losses, schedule, training, checkpointing, eval."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dstdgcn_tpu.engine import PredictionEngine, steplr
from dstdgcn_tpu.engine import losses as L
from dstdgcn_tpu.data import Loader
from dstdgcn_tpu.models import DSTDGCN

REF = "/root/reference"
if REF not in sys.path:
    sys.path.insert(0, REF)


CFG = dict(learn=dict(opt="adam", lr=3e-3, weight_decay=0, gamma=0.9,
                      step_size=5),
           loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
           use_weight=False, inverse=True, max_iter=-1)

MODEL = DSTDGCN(input_channels=6, input_time_frame=4, output_time_frame=4,
                st_gcnn_dropout=0.1, joints_to_consider=22, num_feature=8,
                num_layers=1, layout="h36m")


def test_steplr_matches_torch_schedule():
    sched = steplr(3e-3, 0.9, 5)
    assert sched(0) == pytest.approx(3e-3)
    assert sched(4) == pytest.approx(3e-3)
    assert sched(5) == pytest.approx(3e-3 * 0.9)
    assert sched(14) == pytest.approx(3e-3 * 0.9 ** 2)


def test_losses_match_reference_torch():
    torch = pytest.importorskip("torch")
    try:
        from engine.utils.loss import (mae_error_3d, mpjpe_error_3d,
                                       transition_error_3d)
    except Exception:
        pytest.skip("reference not available")
    rng = np.random.RandomState(0)
    p = rng.randn(4, 8, 66).astype(np.float32)
    t = rng.randn(4, 8, 66).astype(np.float32)
    pt, tt = torch.from_numpy(p), torch.from_numpy(t)
    assert float(L.mpjpe_error(jnp.asarray(p), jnp.asarray(t))) == \
        pytest.approx(float(mpjpe_error_3d(pt, tt)), rel=1e-5)
    assert float(L.mae_error(jnp.asarray(p), jnp.asarray(t))) == \
        pytest.approx(float(mae_error_3d(pt, tt)), rel=1e-5)
    assert float(L.transition_error(jnp.asarray(p), jnp.asarray(t))) == \
        pytest.approx(float(transition_error_3d(pt, tt)), rel=1e-5)


def _toy_data(rng, n=16):
    inputs = rng.randn(n, 8, 66).astype(np.float32)
    inputs_inv = inputs[:, ::-1].copy()
    targets = inputs + 0.1 * rng.randn(n, 8, 66).astype(np.float32)
    all_seqs = rng.randn(n, 8, 96).astype(np.float32)
    return inputs, inputs_inv, targets, all_seqs


def test_training_reduces_loss(rng):
    eng = PredictionEngine(dict(CFG), MODEL)
    data = _toy_data(rng)
    loader = Loader(data, batch_size=8, shuffle=True)
    eng.init(data[0][:1])
    losses = [eng.train(loader, epoch) for epoch in range(4)]
    assert losses[-1] < losses[0]


def test_prng_impl_rbg_trains(rng):
    """engine.prng_impl: rbg (shipped by the tuned configs) swaps only the
    dropout random stream; training must behave identically in structure
    (finite losses, loss decreases)."""
    import jax

    eng = PredictionEngine(dict(CFG, prng_impl="rbg"), MODEL)
    data = _toy_data(rng)
    loader = Loader(data, batch_size=8, shuffle=True)
    eng.init(data[0][:1])
    assert "rbg" in str(jax.random.key_impl(eng.state.dropout_key))
    losses = [eng.train(loader, epoch) for epoch in range(3)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_checkpoint_roundtrip(tmp_path, rng):
    eng = PredictionEngine(dict(CFG), MODEL)
    data = _toy_data(rng)
    loader = Loader(data, batch_size=8)
    eng.init(data[0][:1])
    eng.train(loader, 0)
    eng.save(str(tmp_path), err=1.23, epoch=0, is_best=True)

    eng2 = PredictionEngine(dict(CFG), MODEL)
    eng2.init(data[0][:1], seed=999)  # different init
    epoch, err = eng2.recover(str(tmp_path / "best.ckpt"))
    assert epoch == 0 and err == pytest.approx(1.23)
    for a, b in zip(jax.tree.leaves(eng.state.params),
                    jax.tree.leaves(eng2.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # optimizer moments restored too (the reference loses scheduler state)
    for a, b in zip(jax.tree.leaves(eng.state.opt_state),
                    jax.tree.leaves(eng2.state.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_roundtrip_rbg(tmp_path, rng):
    """Checkpoint save/restore under engine.prng_impl: rbg (the tuned
    configs ship it): wrap_key_data must use the target key's impl —
    the threefry default rejects rbg's (4,)-word key data (r5 review
    finding, confirmed crash before the fix)."""
    eng = PredictionEngine(dict(CFG, prng_impl="rbg"), MODEL)
    data = _toy_data(rng)
    eng.init(data[0][:1])
    eng.train(Loader(data, batch_size=8), 0)
    eng.save(str(tmp_path), err=0.5, epoch=0, is_best=False)
    eng2 = PredictionEngine(dict(CFG, prng_impl="rbg"), MODEL)
    eng2.init(data[0][:1], seed=999)
    epoch, err = eng2.recover(str(tmp_path / "last.ckpt"))
    assert epoch == 0 and err == pytest.approx(0.5)
    assert "rbg" in str(jax.random.key_impl(eng2.state.dropout_key))
    for a, b in zip(jax.tree.leaves(eng.state.params),
                    jax.tree.leaves(eng2.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_cross_prng_impl_restore(tmp_path, rng):
    """A checkpoint written under one dropout PRNG does not silently drop
    its key when restored under the other: the restore names the key and
    both implementations, and the engine state is left untouched."""
    eng = PredictionEngine(dict(CFG), MODEL)  # threefry writer
    data = _toy_data(rng)
    eng.init(data[0][:1])
    eng.save(str(tmp_path), err=0.7, epoch=2, is_best=False)
    eng2 = PredictionEngine(dict(CFG, prng_impl="rbg"), MODEL)  # rbg reader
    eng2.init(data[0][:1], seed=999)
    before = jax.tree.map(np.asarray, eng2.state.params)
    with pytest.raises(ValueError, match="dropout_key.*threefry.*rbg"):
        eng2.recover(str(tmp_path / "last.ckpt"))
    assert "rbg" in str(jax.random.key_impl(eng2.state.dropout_key))
    for a, b in zip(jax.tree.leaves(before),
                    jax.tree.leaves(eng2.state.params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_checkpoint_mismatched_tree_raises(tmp_path, rng):
    """Restoring into a model of another shape fails loudly, naming the
    leaves, instead of loading a partial state."""
    eng = PredictionEngine(dict(CFG), MODEL)
    data = _toy_data(rng)
    eng.init(data[0][:1])
    eng.save(str(tmp_path), err=0.7, epoch=2, is_best=False)
    deeper = DSTDGCN(input_channels=6, input_time_frame=4,
                     output_time_frame=4, st_gcnn_dropout=0.1,
                     joints_to_consider=22, num_feature=8, num_layers=2,
                     layout="h36m")
    eng2 = PredictionEngine(dict(CFG), deeper)
    eng2.init(data[0][:1])
    with pytest.raises(ValueError, match="missing.*encoder_1"):
        eng2.recover(str(tmp_path / "last.ckpt"))
    wider = DSTDGCN(input_channels=6, input_time_frame=4,
                    output_time_frame=4, st_gcnn_dropout=0.1,
                    joints_to_consider=22, num_feature=16, num_layers=1,
                    layout="h36m")
    eng3 = PredictionEngine(dict(CFG), wider)
    eng3.init(data[0][:1])
    with pytest.raises(ValueError, match=r"float32\[22, 8\]"):
        eng3.recover(str(tmp_path / "last.ckpt"))


def test_checkpoint_is_npz_with_tree_paths(tmp_path, rng):
    """The on-disk format: an .npz of tree-path-named leaves plus the JSON
    payload, written atomically (no .tmp left behind)."""
    import json

    eng = PredictionEngine(dict(CFG), MODEL)
    data = _toy_data(rng)
    eng.init(data[0][:1])
    eng.save(str(tmp_path), err=0.25, epoch=3, is_best=True)
    assert sorted(os.listdir(tmp_path)) == ["best.ckpt", "last.ckpt"]
    with np.load(tmp_path / "last.ckpt", allow_pickle=False) as z:
        names = set(z.files)
        meta = json.loads(str(z["__meta__"]))
    assert "params/conv_st_in/block/spatial/wf" in names
    assert "dropout_key" in names
    assert meta["payload"] == dict(lr=eng.lr, err=0.25, epoch=3)


def test_eval_protocol_matches_numpy_reference(rng):
    """On-device eval (scatter + ignore/equal + per-frame MPJPE) vs a plain
    numpy transcription of reference engine/prediction.py:366-404."""
    eng = PredictionEngine(dict(CFG), MODEL)
    data = _toy_data(rng, n=8)
    eng.init(data[0][:1])
    input_n = 4
    eval_frame = np.array([0, 1, 3])
    dims = sorted(j * 3 + k
                  for j in [2, 3, 4, 5, 7, 8, 9, 10, 12, 13, 14, 15, 17, 18,
                            19, 21, 22, 25, 26, 27, 29, 30]
                  for k in range(3))
    jti = np.array([16, 20, 23, 24, 28, 31])
    jte = np.array([13, 19, 22, 13, 27, 30])
    loader = Loader(data, batch_size=8)
    avg, metric = eng.test(loader, input_n, eval_frame, np.array(dims), jti,
                           jte, None, None, "toy")

    # numpy reference computation with our model's outputs
    x = jnp.asarray(data[0])
    out = np.asarray(eng.model.apply(
        {"params": eng.state.params,
         "batch_stats": eng.state.batch_stats},
        eng.transform(x), train=False)[0]).reshape(8, 8, 66)
    all_seqs = data[3]
    pred = all_seqs.copy()
    pred[:, :, dims] = out
    ii = np.concatenate([jti * 3, jti * 3 + 1, jti * 3 + 2])
    ie = np.concatenate([jte * 3, jte * 3 + 1, jte * 3 + 2])
    pred[:, :, ii] = pred[:, :, ie]
    p = pred.reshape(8, 8, 32, 3)[:, input_n:]
    t = all_seqs.reshape(8, 8, 32, 3)[:, input_n:]
    want = np.array([
        np.linalg.norm(p[:, j] - t[:, j], axis=-1).mean()
        for j in eval_frame])
    np.testing.assert_allclose(metric, want, rtol=1e-5)
    assert avg == pytest.approx(want.mean(), rel=1e-5)


def test_inverse_training_halves_combined_loss(rng):
    """inverse=True averages the two directions (prediction.py:267-287)."""
    cfg = dict(CFG)
    data = _toy_data(rng, n=8)

    def one_epoch(inverse):
        c = dict(cfg)
        c["inverse"] = inverse
        eng = PredictionEngine(c, MODEL)
        eng.init(data[0][:1])
        step = eng._build_train_step(None, None, None)
        _, losses = step(eng.state, jnp.asarray(data[0]),
                         jnp.asarray(data[1]), jnp.asarray(data[2]),
                         jnp.asarray(1e-3))
        return losses

    # reported per-direction losses are the forward direction's in both
    # modes; just assert both run and produce finite values
    l1 = one_epoch(True)
    l2 = one_epoch(False)
    assert np.isfinite(float(l1["joint"]))
    assert np.isfinite(float(l2["joint"]))


def test_make_optimizer_param_groups():
    """Bias group gets scaled lr; base group gets weight decay."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from dstdgcn_tpu.engine import make_optimizer

    params = {"dense": {"kernel": jnp.ones((4, 4)), "bias": jnp.ones((4,))}}
    tx = make_optimizer(dict(optimizer_name="sgd", base_lr=1.0,
                             bias_lr_factor=0.1, weight_decay=0.0,
                             momentum=0.0), params)
    state = tx.init(params)
    grads = jax.tree.map(jnp.ones_like, params)
    updates, _ = tx.update(grads, state, params)
    np.testing.assert_allclose(updates["dense"]["kernel"], -1.0)
    np.testing.assert_allclose(updates["dense"]["bias"], -0.1, rtol=1e-6)


def test_step_timer_and_trace(tmp_path):
    import time as _time
    from dstdgcn_tpu.utils.profiling import StepTimer, trace

    t = StepTimer(skip_first=1)
    for _ in range(3):
        t.tic()
        _time.sleep(0.001)
        t.toc()
    assert t.steps == 2 and t.avg_ms >= 1.0 and t.steps_per_s > 0
    assert "steps/s" in t.summary()
    with trace(None):
        pass
    with trace(str(tmp_path / "prof")):
        import jax.numpy as jnp
        jnp.ones(8).sum().block_until_ready()


def test_multi_output_loss_binding():
    """n_out>1: loss specs with out_idx bind to specific model outputs
    (reference ModelWrapper, prediction.py:33-44)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from dstdgcn_tpu.engine import PredictionEngine

    class TwoHead:
        """Minimal multi-output model with the engine's model protocol."""

        def init(self, key, x):
            return {"params": {"w": jnp.ones((1,))}, "batch_stats": {}}

        def apply(self, variables, x, train=False, key=None):
            w = variables["params"]["w"]
            return [x * w, x * (2 * w)], variables["batch_stats"]

    cfg = dict(learn=dict(opt="adam", lr=1e-2, weight_decay=0, gamma=0.9,
                          step_size=5),
               loss=dict(coarse=["cl2", 1.0, 0], fine=["jl2", 1.0, 1]),
               n_out=2, transform="no", use_weight=False, inverse=False,
               max_iter=-1)
    eng = PredictionEngine(cfg, TwoHead())
    rng = np.random.RandomState(0)
    inputs = rng.randn(4, 6, 66).astype(np.float32)
    targets = rng.randn(4, 6, 66).astype(np.float32)
    eng.init(inputs[:1])

    class L:
        def __len__(self):
            return 1

        def __iter__(self):
            yield inputs, inputs, targets, targets

    loss = eng.train(L(), epoch=0)
    assert np.isfinite(loss)
    # eval must use the LAST output
    avg, _ = eng.test(L(), input_n=3, eval_frame=[0, 2])
    assert np.isfinite(avg)

    import pytest
    with pytest.raises(ValueError):
        PredictionEngine({**cfg, "loss": dict(bad=["jl2", 1.0, 5])},
                         TwoHead())


def test_detect_anomaly_raises_on_nan():
    import numpy as np
    import pytest
    from dstdgcn_tpu.engine import PredictionEngine
    from dstdgcn_tpu.models import DSTDGCN

    model = DSTDGCN(input_channels=6, input_time_frame=2,
                    output_time_frame=2, st_gcnn_dropout=0.0,
                    joints_to_consider=22, num_feature=4, num_layers=1,
                    layout="h36m")
    cfg = dict(learn=dict(opt="adam", lr=1e-3, weight_decay=0, gamma=0.9,
                          step_size=5),
               loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
               use_weight=False, inverse=False, max_iter=-1,
               detect_anomaly=True)
    eng = PredictionEngine(cfg, model)
    inputs = np.full((2, 4, 66), np.nan, np.float32)
    targets = np.zeros((2, 4, 66), np.float32)
    eng.init(np.zeros((1, 4, 66), np.float32))

    class L:
        def __len__(self):
            return 1

        def __iter__(self):
            yield inputs, inputs, targets, targets

    with pytest.raises(FloatingPointError, match="non-finite"):
        eng.train(L(), epoch=0)


def test_engine_solver_config_wiring(rng):
    """engine.solver block routes through make_optimizer: with
    bias_lr_factor=0 the bias parameter group must stay frozen while the
    base group trains, and the StepLR schedule must still drive the
    injected learning_rate without error."""
    cfg = dict(CFG)
    cfg["solver"] = dict(optimizer_name="adam", bias_lr_factor=0.0)
    eng = PredictionEngine(cfg, MODEL)
    data = _toy_data(rng)
    loader = Loader(data, batch_size=8)
    eng.init(data[0][:1])
    p0 = jax.tree.map(np.asarray, eng.state.params)
    eng.train(loader, 0)
    eng.train(loader, 6)  # past step_size: schedule must update the lr

    import jax.tree_util as jtu
    flat0 = jtu.tree_flatten_with_path(p0)[0]
    flat1 = {jtu.keystr(path): np.asarray(leaf) for path, leaf in
             jtu.tree_flatten_with_path(eng.state.params)[0]}
    n_bias = n_base_changed = 0
    for path, before in flat0:
        after = flat1[jtu.keystr(path)]
        leaf = str(getattr(path[-1], "key", path[-1]))
        if "bias" in leaf:
            np.testing.assert_array_equal(before, after)
            n_bias += 1
        elif not np.array_equal(before, after):
            n_base_changed += 1
    assert n_bias > 0 and n_base_changed > 0


def test_engine_callbacks_config_wiring(tmp_path, rng):
    """engine.callbacks block drives CallbackLogger: windowed per-loss CSV
    appears in log_dir with one row per epoch."""
    cfg = dict(CFG)
    cfg["callbacks"] = dict(log_dir=str(tmp_path), loss_freq=1, name="train")
    eng = PredictionEngine(cfg, MODEL)
    data = _toy_data(rng)
    loader = Loader(data, batch_size=8)
    eng.init(data[0][:1])
    eng.train(loader, 0)
    eng.train(loader, 1)
    csv_path = tmp_path / "train_loss.csv"
    assert csv_path.exists()
    lines = csv_path.read_text().strip().splitlines()
    assert lines[0].startswith("epoch") and "joint" in lines[0]
    assert len(lines) == 3  # header + 2 epochs
