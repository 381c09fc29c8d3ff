"""Auto knob-selection tests (models/autotune.py).

The measured per-shape winners are default behavior: "auto" knobs
resolve at trace time to the winning (compute_dtype, agg_group)
combination for the batch size, and the resolved model must compute the
same function as the explicitly knobbed one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dstdgcn_tpu.models import DSTDGCN
from dstdgcn_tpu.models.autotune import resolve_auto, resolve_knob

MK = dict(input_channels=6, input_time_frame=10, output_time_frame=5,
          st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=16,
          num_layers=1, layout="h36m")


def test_policy_regimes():
    # H100 winners (autotune.py table): f32 below 64, ungrouped bf16 above
    for n in (1, 2, 32, 63):
        assert resolve_auto(n) == dict(compute_dtype=None,
                                       agg_group_spatial=None,
                                       agg_group_temporal=None)
    for n in (64, 128, 512, 1024, 4096):
        assert resolve_auto(n) == dict(compute_dtype="bfloat16",
                                       agg_group_spatial=None,
                                       agg_group_temporal=None)


def test_resolve_knob_passthrough():
    assert resolve_knob("agg_group_spatial", 7, 128) == 7
    assert resolve_knob("agg_group_spatial", None, 128) is None
    assert resolve_knob("agg_group_spatial", "auto", 128) is None
    assert resolve_knob("compute_dtype", "auto", 128) == "bfloat16"
    assert resolve_knob("compute_dtype", "auto", 1) is None


def _outputs(model, x):
    variables = model.init(jax.random.key(0), x[:1])
    return np.asarray(model.apply(variables, x, train=False)[0])


@pytest.mark.parametrize("batch,explicit", [
    (4, dict(compute_dtype=None, agg_group_spatial=None,
             agg_group_temporal=None)),
    (64, dict(compute_dtype="bfloat16", agg_group_spatial=None,
              agg_group_temporal=None)),
])
def test_auto_matches_explicit_knobs(batch, explicit):
    """The auto model must compute bit-identically to the explicitly
    knobbed model at each regime (same init keys, same knob routing)."""
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(batch, 15, 22, 3), jnp.float32)
    auto = DSTDGCN(**MK, compute_dtype="auto", agg_group_spatial="auto",
                   agg_group_temporal="auto")
    manual = DSTDGCN(**MK, **explicit)
    np.testing.assert_array_equal(_outputs(auto, x), _outputs(manual, x))


def test_auto_config_loads_and_builds():
    """agg_group: auto survives the YAML -> get_model -> apply path."""
    from dstdgcn_tpu.models import get_model
    from dstdgcn_tpu.utils.config import get_config

    cfg = get_config("configs/dstdgcn_h36m_tuned.yaml")
    mcfg = dict(cfg["model"])
    model = get_model(mcfg.pop("name"), **mcfg)
    assert model.agg_group_spatial == "auto"
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(2, 35, 22, 3), jnp.float32)
    variables = model.init(jax.random.key(0), x[:1])
    out, _ = model.apply(variables, x, train=False)
    assert out.shape == (2, 35, 22, 3)


def test_auto_kwargs_follow_policy_boundaries():
    # the b32 train cell (f32 ahead of bf16 on the H100) is what the <64
    # rule encodes; guard it
    assert resolve_auto(32)["compute_dtype"] is None
    assert resolve_auto(64)["compute_dtype"] == "bfloat16"


def test_batch_hint_overrides_ragged_trace_shape():
    # ragged final batch (40) must not flip the knobs when the
    # configured batch (128) is hinted (r5 review finding)
    assert resolve_knob("compute_dtype", "auto", 40) is None
    assert resolve_knob("compute_dtype", "auto", 40, 128) == "bfloat16"
    assert resolve_knob("agg_group_spatial", "auto", 40, 128) is None


def test_auto_resolves_per_chip_batch_under_mesh():
    """Under a data-sharded mesh the traced shape is the GLOBAL batch;
    the policy must resolve on the per-chip shard (global 256 over
    data=8 computes batch-32 per chip -> the f32 regime)."""
    from dstdgcn_tpu.models.autotune import per_chip_batch
    from dstdgcn_tpu.parallel import activation_sharding_context, make_mesh

    assert per_chip_batch(256) == 256     # no mesh: global == per-chip
    mesh = make_mesh(data=8, graph=1)
    with activation_sharding_context(mesh):
        assert per_chip_batch(256) == 32
        assert resolve_knob("compute_dtype", "auto", 256) is None
        assert resolve_knob("compute_dtype", "auto", 1024) == "bfloat16"


def test_batch_hint_globalized_across_processes(monkeypatch):
    """The runner's auto_batch_hint is the PER-PROCESS loader batch;
    under a multi-host launch it must be globalized (x process_count)
    before the per-chip division, or the policy would underestimate the
    per-chip shard by the process count."""
    import jax

    from dstdgcn_tpu.parallel import activation_sharding_context, make_mesh

    monkeypatch.setattr(jax, "process_count", lambda: 4)
    mesh = make_mesh(data=8, graph=1)
    with activation_sharding_context(mesh):
        # per-process hint 256 -> global 1024 -> per-chip 128: tuned regime
        assert resolve_knob("compute_dtype", "auto", 999, 256) == "bfloat16"
        assert resolve_knob("agg_group_spatial", "auto", 999, 256) is None
        # per-process hint 64 -> global 256 -> per-chip 32: f32 regime
        assert resolve_knob("compute_dtype", "auto", 999, 64) is None
