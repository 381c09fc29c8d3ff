"""On-card correctness (marker ``gpu``): small-width GPU vs CPU checks.

Each test takes the ``gpu_device`` fixture, which skips when JAX sees no
GPU.  On the card they run inside ``chip_smoke.py`` (one JAX process), or
directly with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dstdgcn_tpu.models import DSTDGCN

pytestmark = pytest.mark.gpu

SMALL = dict(input_channels=6, input_time_frame=10, output_time_frame=25,
             st_gcnn_dropout=0.1, joints_to_consider=22, num_feature=16,
             num_layers=2, layout="h36m")


def _both(fn, args, gpu):
    cpu = jax.devices("cpu")[0]
    with jax.default_matmul_precision("highest"):
        return [jax.device_get(fn(*jax.device_put(args, d)))
                for d in (gpu, cpu)]


@pytest.mark.parametrize("fast", [False, True])
def test_forward_and_grad_match_cpu(gpu_device, fast):
    model = DSTDGCN(**SMALL, fast=fast)
    rng = np.random.RandomState(0)
    x = rng.randn(8, 35, 22, 3).astype(np.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        variables = model.init(jax.random.key(0), x)

    @jax.jit
    def f(v, xx, key):
        def loss(p):
            out, _ = model.apply({"params": p,
                                  "batch_stats": v["batch_stats"]}, xx,
                                 train=True, key=key)
            return jnp.mean(out ** 2)
        return model.apply(v, xx)[0], jax.grad(loss)(v["params"])

    (out_g, grad_g), (out_c, grad_c) = _both(
        f, (variables, x, jax.random.key(1)), gpu_device)
    scale = np.abs(out_c).max()
    assert np.abs(out_g - out_c).max() <= 1e-5 * scale
    top = max(np.abs(g).max() for g in jax.tree.leaves(grad_c))
    for a, b in zip(jax.tree.leaves(grad_g), jax.tree.leaves(grad_c)):
        assert np.abs(a - b).max() <= 1e-4 * max(np.abs(b).max(),
                                                 1e-3 * top)


def test_engine_train_step_and_checkpoint_on_card(gpu_device, tmp_path):
    from dstdgcn_tpu.data import Loader
    from dstdgcn_tpu.engine import PredictionEngine

    cfg = dict(learn=dict(opt="adam", lr=3e-3, weight_decay=0, gamma=0.9,
                          step_size=5),
               loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
               use_weight=False, inverse=True, max_iter=-1,
               prng_impl="rbg")
    rng = np.random.RandomState(0)
    inputs = rng.randn(16, 35, 66).astype(np.float32)
    data = (inputs, inputs[:, ::-1].copy(), inputs + 0.1, inputs)
    eng = PredictionEngine(cfg, DSTDGCN(**SMALL))
    eng.init(inputs[:1])
    assert all(a.devices() == {gpu_device}
               for a in jax.tree.leaves(eng.state.params))
    loss = eng.train(Loader(data, batch_size=8), epoch=0)
    assert np.isfinite(loss)
    eng.save(str(tmp_path), err=loss, epoch=0, is_best=True)
    eng2 = PredictionEngine(cfg, DSTDGCN(**SMALL))
    eng2.init(inputs[:1], seed=5)
    eng2.recover(str(tmp_path / "best.ckpt"))
    for a, b in zip(jax.tree.leaves(eng.state.params),
                    jax.tree.leaves(eng2.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
