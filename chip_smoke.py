#!/usr/bin/env python
"""On-card smoke test of the DSTD-GCN train and eval path.

Run from the root of a checkout, on a machine with an NVIDIA GPU::

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the mesh phase only

Phases (one GPU):

* ``runner`` — ``main.main`` -> config reader -> runner -> engine at the
  full H36M width (C=64, 5 encoder layers, 10 -> 25 frames, V=22, train
  batch 32) on the seeded ``synthetic`` dataset, for the model blocks of
  ``configs/dstdgcn_h36m_tuned.yaml`` and of the parity config
  ``configs/dstdgcn_h36m.yaml``: a few train steps, evaluation,
  ``last.ckpt``/``best.ckpt``, then ``mode: test`` reloading ``best.ckpt``
  must reproduce the best epoch's eval loss exactly.
* ``correctness`` — the flagship model's eval forward at b128 and one
  train-mode loss + gradient at b32, float32 at ``highest`` matmul
  precision, against the same computation on the CPU backend of this
  process.  Also printed, not asserted: the deviation of the default
  precision (TF32 dots) and of the ``bfloat16`` compute path from the
  highest-precision result.
* ``tests`` — the ``gpu``-marked pytest tests (``tests/test_on_card.py``)
  in this process.
* ``memory`` — ``compiled.memory_analysis()`` of the train step and the
  number of compilations after warm-up (must be 0).
* ``timing`` — plain XLA eval forward of the flagship model and of its
  DSTD-GC op chain at b128: median of 10 runs after warm-up.

``--four-cards``: one train step of the fast variant at full width
(global batch 128) on a data=2 x graph=2 mesh against the same step on
one card, a check that every card holds its shard, the ring and all-gather
``shard_map`` spatial ops against the single-device op, and
``hlo_check.check_overlap`` on the ring's compiled GPU schedule.

The card's name and power limit come from ``nvidia-smi`` (a child process
that does not import JAX); the last line of standard output is one JSON
object ``{"ok": true, "device": {...}}``.  Without a GPU the script exits
non-zero before any phase; any failed phase exits non-zero.  Everything
runs in this one process, so only one JAX process opens the cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

#: GPU vs CPU at float32 "highest" precision.  Forward: max |diff| over
#: max |CPU| of the eval output.  Gradients: max |diff| over all leaves
#: over the largest CPU gradient (the worst single leaf is printed too).
#: Both backends sum in different orders (cuBLAS / XLA:GPU tree
#: reductions vs XLA:CPU loops), so equality is to float32 rounding of
#: sums.  The largest gradients are the scalar gates (alpha_*, PReLU
#: slopes): each sums N*T*V*C = 1.6e6 products (b32) that largely
#: cancel, and the order alone moves them by more than 1e-4 of the
#: largest gradient: the CPU against itself, with the batch rows in
#: another order (same math), differs by 1.5e-4 at the full H36M width,
#: b32.  Hence 1e-3 for the gradients; the forward and the loss hold 1e-5.
FWD_RTOL = 1e-5
GRAD_RTOL = 1e-3
#: reported against, not asserted: the bf16-path bound of the old bench
BF16_BOUND = 2e-2
#: four-card mesh step vs one-card step, both at "highest" precision.
#: The sharded step reduces its gradients in another order (per-device
#: partial sums, then an all-reduce), so the gradients (the first Adam
#: moment) get the same bound as GPU vs CPU above.  Updated parameters:
#: after one Adam step each entry moves by ~lr * sign(gradient), so
#: entries with a gradient above rounding noise must agree to float32
#: rounding of the parameter.
MESH_LOSS_RTOL = 1e-5
MESH_GRAD_RTOL = GRAD_RTOL
MESH_PARAM_ATOL = 1e-6
MESH_OP_RTOL = 1e-5

RUN_ROOT = os.path.join("runs", "chip_smoke")
SYNTHETIC = "configs/dstdgcn_synthetic.yaml"
MODEL_CONFIGS = (("tuned", "configs/dstdgcn_h36m_tuned.yaml"),
                 ("parity", "configs/dstdgcn_h36m.yaml"))


@dataclasses.dataclass(frozen=True)
class Widths:
    """Model and batch sizes of the phases (full H36M width by default)."""

    input_n: int = 10
    output_n: int = 25
    joints: int = 22
    channels: int = 64
    layers: int = 5
    train_batch: int = 32
    eval_batch: int = 128
    mesh_batch: int = 128


FULL = Widths()


def card_info() -> str:
    """``name, power.limit`` lines of nvidia-smi (no JAX in the child)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu(devices) -> None:
    """Refuse to run on anything but GPUs."""
    if not devices or devices[0].platform != "gpu":
        raise SystemExit(
            "chip_smoke.py needs a GPU; JAX reports "
            f"{[d.platform for d in devices]}")


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def selected_phases(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-GPU mesh phase")
    args = ap.parse_args(argv)
    if args.four_cards:
        return ["mesh"]
    return ["runner", "correctness", "tests", "memory", "timing"]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _tree_rel(tree_a, tree_b) -> float:
    """max |a - b| over all leaves, over max |b| over all leaves."""
    import jax
    diff = max(float(np.abs(np.asarray(a, np.float64)
                            - np.asarray(b, np.float64)).max())
               for a, b in zip(jax.tree.leaves(tree_a),
                               jax.tree.leaves(tree_b)))
    top = max(float(np.abs(np.asarray(b)).max())
              for b in jax.tree.leaves(tree_b))
    return diff / max(top, 1e-30)


def _worst_leaf(tree_a, tree_b, floor: float = 1e-3):
    """Worst per-leaf max |a - b| over the leaf's max |b|.  The scale has
    a floor of ``floor`` times the largest leaf: some gradients are zero
    in exact arithmetic (a bias followed by BatchNorm) and hold only
    rounding noise, for which a ratio to themselves means nothing."""
    import jax
    leaves_b = [np.asarray(b, np.float64) for b in jax.tree.leaves(tree_b)]
    top = max(float(np.abs(b).max()) for b in leaves_b)
    errs = {}
    for (p, a), b in zip(jax.tree_util.tree_flatten_with_path(tree_a)[0],
                         leaves_b):
        scale = max(float(np.abs(b).max()), floor * top, 1e-30)
        errs[jax.tree_util.keystr(p)] = float(
            np.abs(np.asarray(a, np.float64) - b).max() / scale)
    name = max(errs, key=errs.get)
    return name, errs[name]


def _check(ok: bool, what: str) -> None:
    print(f"  {'ok ' if ok else 'FAIL'} {what}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: {what}")


def _flagship(w: Widths, **kw):
    from dstdgcn_tpu.models import DSTDGCN
    return DSTDGCN(input_channels=6, input_time_frame=w.input_n,
                   output_time_frame=w.output_n, st_gcnn_dropout=0.1,
                   joints_to_consider=w.joints, num_feature=w.channels,
                   num_layers=w.layers, layout="h36m", **kw)


# -- runner ----------------------------------------------------------------

def _runner_config(model_cfg: str, w: Widths) -> dict:
    from dstdgcn_tpu.utils.config import load_yaml
    with open(model_cfg) as f:
        cfg = load_yaml(f.read())
    with open(SYNTHETIC) as f:
        syn = load_yaml(f.read())
    cfg["runner"] = "synthetic"
    cfg["dataset"] = syn["dataset"]
    for split, n in (("train", 4 * w.train_batch),
                     ("test", 2 * w.train_batch)):
        cfg["dataset"][split]["synthetic"].update(
            input_n=w.input_n, output_n=w.output_n, num_sequences=n)
    cfg["setting"].update(input_n=w.input_n, output_n=w.output_n)
    cfg["setting"]["eval_frame"] = [f for f in cfg["setting"]["eval_frame"]
                                    if f < w.output_n]
    cfg["save"]["files"] = []
    cfg.update(train_batch_size=w.train_batch, test_batch_size=w.train_batch,
               epoch=2, mode="train")
    cfg["engine"]["max_iter"] = 3
    name = cfg["model"]["name"]
    cfg["model"][name].update(
        input_time_frame=w.input_n, output_time_frame=w.output_n,
        joints_to_consider=w.joints, num_feature=w.channels,
        num_layers=w.layers)
    return cfg


def _read_csv(path):
    import csv
    with open(path, newline="") as f:
        return list(csv.reader(f))


def runner_phase(w: Widths = FULL) -> None:
    import main as cli
    from dstdgcn_tpu.utils.config import dump_yaml

    for tag, model_cfg in MODEL_CONFIGS:
        run_dir = os.path.join(RUN_ROOT, tag)
        shutil.rmtree(run_dir, ignore_errors=True)
        os.makedirs(run_dir)
        cfg = _runner_config(model_cfg, w)
        train_cfg = os.path.join(run_dir, "train.yaml")
        with open(train_cfg, "w") as f:
            f.write(dump_yaml(cfg))
        t0 = time.perf_counter()
        runner = cli.main(["--run_dir", run_dir, "--config", train_cfg])
        rows = _read_csv(os.path.join(run_dir, "training_loss.csv"))
        head, epochs, best = rows[0], rows[1:-1], rows[-1]
        print(f"[runner:{tag}] {model_cfg} model "
              f"{cfg['model']['name']} trained {len(epochs)} epochs x "
              f"{cfg['engine']['max_iter']} steps at batch {w.train_batch} "
              f"in {time.perf_counter() - t0:.1f} s (compile included), "
              f"{runner.engine.num_params()} parameters")
        for r in epochs:
            print("  " + ", ".join(f"{h}={v}" for h, v in zip(head, r)))
        losses = [float(r[head.index("train_loss")]) for r in epochs]
        _check(all(np.isfinite(losses)), f"finite train losses {losses}")
        ckpts = os.path.join(run_dir, "checkpoints")
        _check(all(os.path.exists(os.path.join(ckpts, c))
                   for c in ("last.ckpt", "best.ckpt")),
               "last.ckpt and best.ckpt written")

        cfg.update(mode="test")
        cfg["model"].update(load=True,
                            ckpt=os.path.join(ckpts, "best.ckpt"))
        test_cfg = os.path.join(run_dir, "test.yaml")
        with open(test_cfg, "w") as f:
            f.write(dump_yaml(cfg))
        cli.main(["--run_dir", run_dir, "--config", test_cfg])
        test = _read_csv(os.path.join(run_dir, "testing_loss.csv"))
        want = best[head.index("test_loss")]
        got = test[1][test[0].index("test_loss")]
        _check(got == want, f"best.ckpt reload test_loss {got} == best "
                            f"epoch eval {want}")


# -- correctness -----------------------------------------------------------

def _perturbed_variables(model, x, seed=0):
    """Seeded random weights with every gate/alpha/affine nonzero, and
    BatchNorm running statistics set to the batch statistics of ``x`` —
    so the eval forward normalizes like training does.  (Init statistics
    (0, 1) against unnormalized activations make the eval network
    ill-conditioned, and a precision comparison then measures the
    conditioning.)"""
    import jax
    variables = model.init(jax.random.key(seed), x)
    leaves, tdef = jax.tree_util.tree_flatten(variables["params"])
    keys = jax.random.split(jax.random.key(seed + 1), len(leaves))
    params = jax.tree_util.tree_unflatten(tdef, [
        l + 0.05 * jax.random.normal(k, l.shape, l.dtype)
        for l, k in zip(leaves, keys)])
    init = variables["batch_stats"]
    _, moved = model.apply({"params": params, "batch_stats": init}, x,
                           train=True, key=jax.random.key(seed + 2))
    # one update is (1 - m) * init + m * batch with m = 0.1: solve for batch
    stats = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1, moved,
                         init)
    return {"params": params, "batch_stats": stats}


def _forward_and_grad(model):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def forward(variables, x):
        return model.apply(variables, x, train=False)[0]

    @jax.jit
    def loss_and_grad(variables, x, y, key):
        def loss(params):
            out, _ = model.apply({"params": params,
                                  "batch_stats": variables["batch_stats"]},
                                 x, train=True, key=key)
            return jnp.mean(jnp.linalg.norm(out - y, axis=-1))
        return jax.value_and_grad(loss)(variables["params"])

    return forward, loss_and_grad


def correctness_phase(w: Widths = FULL, ref_device=None) -> None:
    import jax
    from dstdgcn_tpu.models.autotune import resolve_auto

    dev = jax.devices()[0]
    cpu = ref_device or jax.devices("cpu")[0]
    t = w.input_n + w.output_n
    rng = np.random.RandomState(0)
    x_eval = rng.randn(w.eval_batch, t, w.joints, 3).astype(np.float32)
    x_train = rng.randn(w.train_batch, t, w.joints, 3).astype(np.float32)
    y_train = rng.randn(w.train_batch, t, w.joints, 3).astype(np.float32)
    key = jax.random.key(3)             # threefry: same mask on both sides
    model = _flagship(w)
    with jax.default_matmul_precision("highest"), jax.default_device(cpu):
        variables = _perturbed_variables(model, x_train)
    forward, loss_and_grad = _forward_and_grad(model)

    def run(device, precision):
        args = jax.device_put((variables, x_eval, x_train, y_train, key),
                              device)
        with jax.default_matmul_precision(precision):
            out = forward(args[0], args[1])
            loss, grads = loss_and_grad(args[0], args[2], args[3], args[4])
        return jax.device_get((out, loss, grads))

    ref = run(cpu, "highest")
    hi = run(dev, "highest")
    print(f"[correctness] flagship eval forward b{w.eval_batch} and train "
          f"loss/grad b{w.train_batch}, float32 'highest': {dev.device_kind}"
          f" vs {cpu.platform}")
    e_fwd = _rel(hi[0], ref[0])
    e_loss = _rel(hi[1], ref[1])
    e_grad = _tree_rel(hi[2], ref[2])
    leaf, e_leaf = _worst_leaf(hi[2], ref[2])
    print(f"  highest: forward {e_fwd:.3e}, loss {e_loss:.3e}, gradients "
          f"{e_grad:.3e} (worst leaf {leaf}: {e_leaf:.3e})")
    default = run(dev, "default")
    leaf_d, e_leaf_d = _worst_leaf(default[2], hi[2])
    print(f"  default precision (TF32 dots) vs highest: forward "
          f"{_rel(default[0], hi[0]):.3e}, loss {_rel(default[1], hi[1]):.3e}"
          f", gradients {_tree_rel(default[2], hi[2]):.3e} (worst leaf "
          f"{leaf_d}: {e_leaf_d:.3e})")
    auto = resolve_auto(w.eval_batch)
    bf16 = _flagship(w, compute_dtype="bfloat16",
                     agg_group_spatial=auto["agg_group_spatial"],
                     agg_group_temporal=auto["agg_group_temporal"])
    fwd16, _ = _forward_and_grad(bf16)
    args = jax.device_put((variables, x_eval), dev)
    with jax.default_matmul_precision("highest"):
        out16 = jax.device_get(fwd16(*args))
    e16 = _rel(out16, hi[0])
    print(f"  bfloat16 path (agg groups {auto['agg_group_spatial']},"
          f"{auto['agg_group_temporal']}) vs highest: forward {e16:.3e} "
          f"({'within' if e16 <= BF16_BOUND else 'OUTSIDE'} the {BF16_BOUND}"
          f" bound)")
    _check(np.isfinite(hi[0]).all() and hi[0].shape == ref[0].shape,
           f"eval output finite, shape {hi[0].shape}")
    _check(e_fwd <= FWD_RTOL, f"forward rel err {e_fwd:.3e} <= {FWD_RTOL}")
    _check(e_loss <= FWD_RTOL, f"loss {float(hi[1]):.6f} rel err "
                               f"{e_loss:.3e} <= {FWD_RTOL}")
    _check(e_grad <= GRAD_RTOL, f"gradient rel err {e_grad:.3e} <= "
                                f"{GRAD_RTOL}")


# -- memory / compile count ------------------------------------------------

def _train_engine(model, w: Widths, batch: int, **cfg):
    import jax.numpy as jnp
    from dstdgcn_tpu.engine import PredictionEngine

    config = dict(learn=dict(opt="adam", lr=3e-3, weight_decay=0, gamma=0.9,
                             step_size=5),
                  loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
                  use_weight=False, inverse=True, max_iter=-1, **cfg)
    eng = PredictionEngine(config, model)
    t = w.input_n + w.output_n
    rng = np.random.RandomState(0)
    inputs = rng.randn(batch, t, w.joints * 3).astype(np.float32)
    targets = rng.randn(batch, t, w.joints * 3).astype(np.float32)
    eng.init(inputs[:1], seed=0)
    batch_args = (jnp.asarray(inputs), jnp.asarray(inputs[:, ::-1]),
                  jnp.asarray(targets), jnp.asarray(3e-3, jnp.float32))
    return eng, eng._build_train_step(None, None, None), batch_args


class CompileCounter:
    """Counts lowerings to XLA (every new executable, cached or not)."""

    def __init__(self):
        import jax
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **kw):
        if event == "/jax/core/compile/jaxpr_to_mlir_module_duration":
            self.count += 1


def memory_phase(w: Widths = FULL) -> None:
    import jax

    model = _flagship(w)
    eng, step, args = _train_engine(model, w, w.train_batch)
    compiled = step.lower(eng.state, *args).compile()
    mem = compiled.memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes", "temp_size_in_bytes",
              "generated_code_size_in_bytes")
    print(f"[memory] train step b{w.train_batch} memory_analysis: "
          + ", ".join(f"{k}={getattr(mem, k)}" for k in fields
                      if hasattr(mem, k)))
    counter = CompileCounter()
    state = eng.state
    for _ in range(2):                          # warm-up
        state, losses = step(state, *args)
    jax.block_until_ready(losses)
    before = counter.count
    for _ in range(5):
        state, losses = step(state, *args)
    jax.block_until_ready(losses)
    n = counter.count - before
    _check(n == 0, f"{n} compilations in 5 train steps after warm-up")
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        print(f"  peak_bytes_in_use {stats['peak_bytes_in_use']}")


# -- timing ----------------------------------------------------------------

def _median_ms(fn, x, runs: int = 10, warmup: int = 2):
    import jax
    for _ in range(warmup):
        jax.block_until_ready(fn(x))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), float(min(times)), float(max(times))


def timing_phase(w: Widths = FULL) -> None:
    import jax
    import jax.numpy as jnp

    import bench

    dev = jax.devices()[0]
    t = w.input_n + w.output_n
    rng = np.random.RandomState(0)
    model = _flagship(w)
    x = jnp.asarray(rng.randn(w.eval_batch, t, w.joints, 3), jnp.float32)
    variables = model.init(jax.random.key(0), x[:1])
    fwd = jax.jit(lambda xx: model.apply(variables, xx, train=False)[0])
    med, lo, hi = _median_ms(fwd, x)
    print(f"[timing] {dev.device_kind}: flagship eval forward b{w.eval_batch} "
          f"f32 (default precision) median {med:.3f} ms (min {lo:.3f}, max "
          f"{hi:.3f}, 10 runs)")
    blocks = w.layers + 2
    params = bench._naive_params(rng, blocks, w.channels, t, w.joints)
    xc = jnp.asarray(rng.randn(w.eval_batch, t, w.joints, w.channels),
                     jnp.float32)
    chain = jax.jit(lambda xx: bench.stacked_forward(params, xx))
    med, lo, hi = _median_ms(chain, xc)
    print(f"  DSTD-GC op chain ({blocks} spatial+temporal blocks) "
          f"b{w.eval_batch} f32 median {med:.3f} ms (min {lo:.3f}, max "
          f"{hi:.3f}, 10 runs)")


# -- four cards ------------------------------------------------------------

def mesh_phase(w: Widths = FULL) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from dstdgcn_tpu.ops import dstd as ops
    from dstdgcn_tpu.parallel import (activation_sharding_context, hlo_check,
                                      make_mesh)
    from dstdgcn_tpu.parallel.shard import (dstd_spatial_edge_partitioned,
                                            dstd_spatial_ring)

    devices = jax.devices()
    _check(len(devices) >= 4, f"{len(devices)} devices (need 4)")
    mesh = make_mesh(data=2, graph=2, devices=devices[:4])
    model = _flagship(w, fast=True)
    print(f"[mesh] fast variant, global batch {w.mesh_batch}, mesh "
          f"{dict(mesh.shape)} vs one card, float32 'highest'")
    with jax.default_matmul_precision("highest"):
        eng1, step1, args1 = _train_engine(model, w, w.mesh_batch)
        state1, losses1 = step1(eng1.state, *args1)
        eng4, step4, args4 = _train_engine(model, w, w.mesh_batch)
        eng4.mesh = mesh
        eng4.init(np.asarray(args4[0][:1]), seed=0)
        sh = NamedSharding(mesh, P("data"))
        batch4 = [jax.device_put(a, sh) for a in args4[:3]]
        with activation_sharding_context(mesh):
            state4, losses4 = step4(eng4.state, *batch4, args4[3])
        jax.block_until_ready((state1, state4))
    for name in losses1:
        e = _rel(losses4[name], losses1[name])
        _check(e <= MESH_LOSS_RTOL, f"loss {name} {float(losses4[name]):.6f}"
                                    f" rel err {e:.3e} <= {MESH_LOSS_RTOL}")
    # the first Adam moment is (1 - b1) * gradient: compares gradients
    mu1 = state1.opt_state.inner_state[0].mu
    mu4 = state4.opt_state.inner_state[0].mu
    e = _tree_rel(mu4, mu1)
    leaf, e_leaf = _worst_leaf(mu4, mu1)
    _check(e <= MESH_GRAD_RTOL, f"gradients (Adam mu) rel err {e:.3e} <= "
                                f"{MESH_GRAD_RTOL} (worst leaf {leaf}: "
                                f"{e_leaf:.3e})")
    # entries whose gradient is above rounding noise (1e-4 of the largest
    # gradient) must match; the rest may flip sign under either order
    top = max(float(np.abs(np.asarray(m)).max())
              for m in jax.tree.leaves(mu1))
    worst, loose, total = 0.0, 0, 0
    for p1, p4, m in zip(jax.tree.leaves(state1.params),
                         jax.tree.leaves(state4.params),
                         jax.tree.leaves(mu1)):
        live = np.abs(np.asarray(m)) > 1e-4 * top
        d = np.abs(np.asarray(p4) - np.asarray(p1))
        worst = max(worst, float(d[live].max(initial=0.0)))
        loose += int((~live).sum())
        total += d.size
    _check(worst <= MESH_PARAM_ATOL,
           f"updated params max diff {worst:.2e} <= {MESH_PARAM_ATOL} "
           f"({total - loose}/{total} entries with a gradient above noise)")
    shard_devs = [{s.device for s in a.addressable_shards}
                  for a in batch4 + jax.tree.leaves(state4.params)]
    _check(all(len(s) == 4 for s in shard_devs),
           "batch and every updated parameter have shards on 4 distinct "
           "devices")
    per_dev = {s.device: s.data.shape[0]
               for s in batch4[0].addressable_shards}
    print(f"  batch rows per device: "
          f"{ {d.id: n for d, n in sorted(per_dev.items(), key=str)} }")

    rng = np.random.RandomState(5)
    t = w.input_n + w.output_n
    c, v = w.channels, w.joints
    mk = lambda *s: jnp.asarray(rng.randn(*s) * 0.2, jnp.float32)  # noqa
    args = (mk(w.mesh_batch, t, v, c), mk(2, v, v), jnp.asarray(0.5),
            mk(2, c, c), mk(2, c), mk(2, c, 2), mk(2, 2), mk(2, c, 2),
            mk(2, 2), mk(2, 2, t, t), mk(2, t))
    with jax.default_matmul_precision("highest"):
        want = jax.device_get(jax.jit(ops.dstd_spatial)(*args))
        for name, fn in (("ring", dstd_spatial_ring),
                         ("all-gather", dstd_spatial_edge_partitioned)):
            jf = jax.jit(lambda *a, fn=fn: fn(mesh, *a, batch_sharded=True))
            got = jax.device_get(jf(*args))
            e = _rel(got, want)
            _check(e <= MESH_OP_RTOL, f"shard_map {name} spatial op rel err "
                                      f"{e:.3e} <= {MESH_OP_RTOL}")
        ring_txt = jax.jit(lambda *a: dstd_spatial_ring(
            mesh, *a, batch_sharded=True)).lower(*args).compile().as_text()
    ov = hlo_check.check_overlap(ring_txt)
    print(f"  ring schedule: {ov['num_overlapped']} of {ov['num_pairs']} "
          f"async collective-permute pairs bracket matmuls: "
          + "; ".join(f"{p['start']}: {len(p['compute_between'])}"
                      for p in ov["pairs"]))
    os.makedirs(RUN_ROOT, exist_ok=True)
    with open(os.path.join(RUN_ROOT, "ring_schedule_gpu.txt"), "w") as f:
        f.write(ring_txt)


# -- on-card tests ---------------------------------------------------------

class _Outcomes:
    """pytest plugin: counts test outcomes."""

    def __init__(self):
        self.counts = {}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome == "skipped":
            self.counts[report.outcome] = self.counts.get(report.outcome,
                                                          0) + 1


def tests_phase(w: Widths = FULL) -> None:
    """The ``gpu``-marked tests, in this process (one JAX process per
    card); each must pass, none may skip."""
    import pytest

    seen = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "tests/test_on_card.py"], plugins=[seen])
    print(f"[tests] on-card tests: {seen.counts}")
    _check(rc == 0 and seen.counts.get("passed", 0) > 0
           and set(seen.counts) == {"passed"},
           f"pytest -m gpu exit {int(rc)}, outcomes {seen.counts}")


PHASES = {"runner": runner_phase, "correctness": correctness_phase,
          "tests": tests_phase, "memory": memory_phase,
          "timing": timing_phase, "mesh": mesh_phase}


def main(argv=None) -> int:
    phases = selected_phases(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    import jax

    devices = jax.devices()
    require_gpu(devices)
    from dstdgcn_tpu.utils.compile_cache import enable_compile_cache
    print(f"compile cache: {enable_compile_cache()}")
    print(f"card: {card_info()}")
    print(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}")
    for name in phases:
        t0 = time.perf_counter()
        PHASES[name]()
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s",
              flush=True)
    if phases == ["mesh"]:
        devices = devices[:4]
    print(result_line(devices))
    return 0


if __name__ == "__main__":
    sys.exit(main())
