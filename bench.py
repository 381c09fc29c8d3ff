#!/usr/bin/env python
"""Benchmark harness for the DSTD-GC compute path on an NVIDIA GPU.

Measures the flagship DSTD-GCN op chain (full H36M config), the full TRAIN
step (2 forwards + backward + Adam, the reference's hot loop,
engine/prediction.py:215-304) and the eval forward on the attached GPU,
and reports dynamic-graph edges processed per second — each (frame,
src-joint, dst-joint) / (joint, src-frame, dst-frame) pair costs one SDDMM
score plus one SpMM multiply-accumulate, per stacked kernel.

``vs_baseline`` compares against a reference-style implementation
(channels-first layout, per-kernel Python loop, op-by-op einsums mirroring
the reference's model/dstdgcn.py) jitted on the same card — what a direct
port of the PyTorch graph gives XLA.

Timing: warm up, then the median of repeated calls, each ending in
``block_until_ready``.  Every result names the device (platform, kind,
count, power limit); a run without a GPU fails.

    python bench.py              # one JSON line; full record in
                                 # runs/bench.json
    python bench.py --autotune   # interleaved f32 / bf16 / bf16+(5,2)
                                 # sweep behind models/autotune.py
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np

#: published dense peaks per device kind (NVIDIA H100 Tensor Core GPU
#: datasheet, SXM part, without sparsity): bf16 FLOP/s and HBM bytes/s.
#: A device missing here is an error, not a default.
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_flops=989e12, hbm_bytes_per_s=3.35e12),
}

RESULT = {
    "metric": "edges/s/chip (SpMM+SDDMM)", "value": 0.0, "unit": "edges/s",
    "vs_baseline": 0.0, "detail": {},
}


def device_peaks(kind: str) -> dict:
    if kind not in PEAKS:
        raise ValueError(f"no published peaks for device kind {kind!r}; "
                         f"known: {sorted(PEAKS)}")
    return PEAKS[kind]


def device_record() -> dict:
    """platform / kind / count of the JAX devices and the card's power
    limit (nvidia-smi, read by a child process that does not use JAX)."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(f"bench.py measures a GPU; JAX reports "
                           f"{devs[0].platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs), nvidia_smi=smi.strip().splitlines()[0])


def _edges_per_forward(n, t, v, num_blocks, k_s=2, k_t=1):
    spatial = k_s * n * t * v * v
    temporal = k_t * n * v * t * t
    return num_blocks * (spatial + temporal)


def _flops_per_forward(n, t, v, c, num_blocks, k_s=2, k_t=1, r=2):
    """Dense-equivalent matmul FLOPs of one op-chain forward (projections
    + q/k + mixing + aggregation; tanh counted as 0)."""
    sp = (k_s * n * t * v * c * c * 2            # feature projection
          + 2 * k_s * n * t * v * c * r * 2      # q/k projections
          + k_s * n * v * v * (r * t) * t * 2    # frame mixing
          + k_s * n * t * v * v * c * 2)         # aggregation
    tm = (k_t * n * t * v * c * c * 2
          + 2 * k_t * n * t * v * c * r * 2
          + k_t * n * t * t * (r * v) * v * 2
          + k_t * n * v * t * t * c * 2)
    return num_blocks * (sp + tm)


def naive_reference_forward(params_list, x_ncTV):
    """Reference-structured forward: per-kernel loop, separate einsums,
    channels-first (N, C, T, V) — the shape of a direct port."""
    import jax.numpy as jnp

    x = x_ncTV
    for p in params_list:
        # spatial kernels, summed in a Python loop (dstdgcn.py:145-151)
        y = None
        for k in range(p["wf_s"].shape[0]):
            xf = jnp.einsum("nctv,cd->ndtv", x, p["wf_s"][k]) \
                + p["bf_s"][k][None, :, None, None]
            xm1 = jnp.einsum("nctv,cr->nrtv", x, p["wm1_s"][k]) \
                + p["bm1_s"][k][None, :, None, None]
            xm2 = jnp.einsum("nctv,cr->nrtv", x, p["wm2_s"][k]) \
                + p["bm2_s"][k][None, :, None, None]
            n_, r_, t_, v_ = xm1.shape
            sc = jnp.tanh(xm1.reshape(n_, r_ * t_, v_)[:, :, :, None]
                          - xm2.reshape(n_, r_ * t_, v_)[:, :, None, :])
            dyn = jnp.einsum("nsvw,ts->ntvw",
                             sc.reshape(n_, r_ * t_, v_, v_),
                             p["wrm_s_ref"][k]) \
                + p["brm_s"][k][None, :, None, None]
            adj = dyn * p["alpha_s"] + p["base_s"][k][None, None]
            z = jnp.einsum("nctv,ntvw->nctw", xf, adj)
            y = z if y is None else y + z
        x = y
        # temporal kernel (dstdgcn.py:156-161)
        y = None
        for k in range(p["wf_t"].shape[0]):
            xf = jnp.einsum("nctv,cd->ndtv", x, p["wf_t"][k]) \
                + p["bf_t"][k][None, :, None, None]
            xm1 = jnp.einsum("nctv,cr->nrtv", x, p["wm1_t"][k]) \
                + p["bm1_t"][k][None, :, None, None]
            xm2 = jnp.einsum("nctv,cr->nrtv", x, p["wm2_t"][k]) \
                + p["bm2_t"][k][None, :, None, None]
            xm1 = jnp.transpose(xm1, (0, 1, 3, 2))
            xm2 = jnp.transpose(xm2, (0, 1, 3, 2))
            n_, r_, v_, t_ = xm1.shape
            sc = jnp.tanh(xm1.reshape(n_, r_ * v_, t_)[:, :, :, None]
                          - xm2.reshape(n_, r_ * v_, t_)[:, :, None, :])
            dyn = jnp.einsum("nstu,vs->nvtu",
                             sc.reshape(n_, r_ * v_, t_, t_),
                             p["wrm_t_ref"][k]) \
                + p["brm_t"][k][None, :, None, None]
            adj = dyn * p["alpha_t"] + p["base_t"][k][None, None]
            z = jnp.einsum("nctv,nvtu->ncuv", xf, adj)
            y = z if y is None else y + z
        x = y
    return x


def _naive_params(rng, num_blocks, c, t, v, k_s=2, k_t=1):
    import jax.numpy as jnp

    def mk(*shape):
        return jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.05)

    out = []
    for _ in range(num_blocks):
        # wrm stored in both layouts from the same values: torch conv layout
        # (ref_out, R*ref_in) for the naive path, (R, ref_in, ref_out) for
        # ours (see utils/convert.py::_rm)
        wrm_s_ref = mk(k_s, t, 2 * t)
        wrm_t_ref = mk(k_t, v, 2 * v)
        out.append(dict(
            wf_s=mk(k_s, c, c), bf_s=mk(k_s, c),
            wm1_s=mk(k_s, c, 2), bm1_s=mk(k_s, 2),
            wm2_s=mk(k_s, c, 2), bm2_s=mk(k_s, 2),
            wrm_s_ref=wrm_s_ref,
            wrm_s=wrm_s_ref.reshape(k_s, t, 2, t).transpose(0, 2, 3, 1),
            brm_s=mk(k_s, t),
            base_s=mk(k_s, v, v), alpha_s=jnp.asarray(0.5),
            wf_t=mk(k_t, c, c), bf_t=mk(k_t, c),
            wm1_t=mk(k_t, c, 2), bm1_t=mk(k_t, 2),
            wm2_t=mk(k_t, c, 2), bm2_t=mk(k_t, 2),
            wrm_t_ref=wrm_t_ref,
            wrm_t=wrm_t_ref.reshape(k_t, v, 2, v).transpose(0, 2, 3, 1),
            brm_t=mk(k_t, v),
            base_t=mk(k_t, t, t), alpha_t=jnp.asarray(0.5),
        ))
    return out


def stacked_forward(params_list, x_ntvc, dtype=None, agg_group_s=None,
                    agg_group_t=None, agg="right"):
    """Our path: stacked-kernel contractions of ``ops.dstd`` (optionally
    with bf16 activation flow and/or block-diagonal grouped
    aggregation)."""
    import jax.numpy as jnp

    from dstdgcn_tpu.ops import dstd as ops

    kw_s = {"dtype": dtype, "agg": agg, "agg_group": agg_group_s}
    kw_t = {"dtype": dtype, "agg": agg, "agg_group": agg_group_t}
    x = x_ntvc
    for p in params_list:
        x = ops.dstd_spatial(x, p["base_s"], p["alpha_s"], p["wf_s"],
                             p["bf_s"], p["wm1_s"], p["bm1_s"], p["wm2_s"],
                             p["bm2_s"], p["wrm_s"], p["brm_s"], **kw_s)
        x = ops.dstd_temporal(x, p["base_t"], p["alpha_t"], p["wf_t"],
                              p["bf_t"], p["wm1_t"], p["bm1_t"], p["wm2_t"],
                              p["bm2_t"], p["wrm_t"], p["brm_t"], **kw_t)
    return x.astype(jnp.float32) if x.dtype != jnp.float32 else x


def median_ms(fn, *args, runs=10, warmup=2, inner=1):
    """Median wall time (ms) of ``inner`` back-to-back calls over ``runs``
    repeats, after ``warmup`` calls; each repeat ends in
    ``block_until_ready``."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        times.append((time.perf_counter() - t0) * 1e3 / inner)
    return float(np.median(times))


def _train_step(n_batch, compute_dtype=None, agg_group=(None, None),
                prng_impl=None, dropout=0.1):
    """The real engine train step on the flagship model (reference hot
    loop: engine/prediction.py:215-304) and its arguments."""
    import jax.numpy as jnp

    from dstdgcn_tpu.engine import PredictionEngine
    from dstdgcn_tpu.models import DSTDGCN

    model = DSTDGCN(input_channels=6, input_time_frame=10,
                    output_time_frame=25, st_gcnn_dropout=dropout,
                    joints_to_consider=22, num_feature=64, num_layers=5,
                    layout="h36m", compute_dtype=compute_dtype,
                    agg_group_spatial=agg_group[0],
                    agg_group_temporal=agg_group[1])
    cfg = dict(learn=dict(opt="adam", lr=3e-3, weight_decay=0, gamma=0.96,
                          step_size=5),
               loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
               use_weight=False, inverse=True, max_iter=-1,
               prng_impl=prng_impl)
    eng = PredictionEngine(cfg, model)
    rng = np.random.RandomState(0)
    inputs = jnp.asarray(rng.randn(n_batch, 35, 66), jnp.float32)
    targets = jnp.asarray(rng.randn(n_batch, 35, 66), jnp.float32)
    eng.init(np.asarray(inputs[:1]))
    step = eng._build_train_step(None, None, None)
    return eng, step, (inputs, inputs[:, ::-1], targets,
                       jnp.asarray(3e-3, jnp.float32))


def bench_train_step(n_batch, runs=10, **kw):
    """Median ms of one train step (state carried across calls)."""
    eng, step, args = _train_step(n_batch, **kw)
    box = [eng.state]

    def one():
        box[0], losses = step(box[0], *args)
        return losses

    return median_ms(one, runs=runs)


def _eval_forward(n_batch, **knobs):
    import jax
    import jax.numpy as jnp

    from dstdgcn_tpu.models import DSTDGCN

    model = DSTDGCN(input_channels=6, input_time_frame=10,
                    output_time_frame=25, st_gcnn_dropout=0.1,
                    joints_to_consider=22, num_feature=64, num_layers=5,
                    layout="h36m", **knobs)
    x = jnp.asarray(np.random.RandomState(0).randn(n_batch, 35, 22, 3),
                    jnp.float32)
    variables = model.init(jax.random.key(0), x[:1])
    return jax.jit(lambda xx: model.apply(variables, xx)[0]), x


def bench_inference(n_batch=128):
    """Serving path: eval-mode forward of the flagship model, f32 and the
    bf16 + (5,2) grouped knobs."""
    out = {}
    for name, knobs in (("infer_ms_standard", {}),
                        ("infer_ms_standard_bd_bf16",
                         dict(compute_dtype="bfloat16", agg_group_spatial=5,
                              agg_group_temporal=2))):
        fwd, x = _eval_forward(n_batch, **knobs)
        out[name] = round(median_ms(fwd, x), 3)
    out["infer_seq_per_s"] = round(
        n_batch / (min(out.values()) * 1e-3), 1)
    return out


#: the settings behind models/autotune.py, timed interleaved
AUTOTUNE_SETTINGS = {
    "f32": dict(compute_dtype=None, agg_group=(None, None)),
    "bf16": dict(compute_dtype="bfloat16", agg_group=(None, None)),
    "bf16_g52": dict(compute_dtype="bfloat16", agg_group=(5, 2)),
}


def autotune_sweep(rounds=7, train_batches=(32, 128), eval_batches=(1, 512)):
    """Interleaved medians (ms) of each AUTOTUNE_SETTINGS entry: the train
    step at ``train_batches`` and the eval forward at ``eval_batches``.
    Each round times every setting once (the mean of a few back-to-back
    calls), so drift hits all settings alike."""
    import jax

    cells = {}
    for n in train_batches:
        for name, kw in AUTOTUNE_SETTINGS.items():
            eng, step, args = _train_step(n, **kw)
            box = [eng.state]

            def one(step=step, box=box, args=args):
                box[0], losses = step(box[0], *args)
                return losses

            cells[(f"train_b{n}", name)] = one
    for n in eval_batches:
        for name, kw in AUTOTUNE_SETTINGS.items():
            knobs = dict(compute_dtype=kw["compute_dtype"],
                         agg_group_spatial=kw["agg_group"][0],
                         agg_group_temporal=kw["agg_group"][1])
            fwd, x = _eval_forward(n, **knobs)
            cells[(f"eval_b{n}", name)] = (lambda fwd=fwd, x=x: fwd(x))
    for fn in cells.values():                       # compile + warm up
        jax.block_until_ready(fn())
        jax.block_until_ready(fn())
    samples = {k: [] for k in cells}
    for _ in range(rounds):
        for k, fn in cells.items():
            samples[k].append(median_ms(fn, runs=1, warmup=0, inner=5))
    out = {}
    for (cell, name), ts in samples.items():
        out.setdefault(cell, {})[name] = dict(
            median_ms=round(float(np.median(ts)), 4),
            min_ms=round(min(ts), 4), max_ms=round(max(ts), 4))
    for cell, row in out.items():
        row["winner"] = min(
            (k for k in row if k != "winner"),
            key=lambda k: row[k]["median_ms"])
    return out


def tether_check(params, x_ntvc, dtype_name="bfloat16"):
    """Assert the bench-local candidate (stacked_forward) computes the SAME
    function as the shipped module path (models.layers.DSTDGC -> ops.dstd)
    under identical weights; returns the max relative error over the full
    op chain.

    Per-dtype: "bfloat16" runs the tuned knobs (bf16 + (5,2) grouping),
    "float32" the plain path, on a small batch (the check compares two
    formulations of one function, so the batch size does not matter)."""
    import jax
    import jax.numpy as jnp

    from dstdgcn_tpu.models.layers import DSTDGC

    x_ntvc = x_ntvc[:4]
    t, v, c = x_ntvc.shape[1], x_ntvc.shape[2], x_ntvc.shape[3]
    names = ["wf", "bf", "wm1", "bm1", "wm2", "bm2", "wrm", "brm"]
    bf16 = dtype_name == "bfloat16"
    kw = (dict(compute_dtype="bfloat16") if bf16 else {})
    mod_s = DSTDGC(out_channels=c, ref_len=t, num_kernels=2, mode="spatial",
                   agg_group=5 if bf16 else None, **kw)
    mod_t = DSTDGC(out_channels=c, ref_len=v, num_kernels=1, mode="temporal",
                   agg_group=2 if bf16 else None, **kw)

    @jax.jit
    def module_path(xx):
        for p in params:
            xx = mod_s.apply({n_: p[f"{n_}_s"] for n_ in names}, xx,
                             p["base_s"], p["alpha_s"])
            xx = mod_t.apply({n_: p[f"{n_}_t"] for n_ in names}, xx,
                             p["base_t"], p["alpha_t"])
        return xx.astype(jnp.float32)

    @jax.jit
    def candidate_path(xx):
        if bf16:
            return stacked_forward(params, xx, dtype=jnp.bfloat16,
                                   agg_group_s=5, agg_group_t=2)
        return stacked_forward(params, xx)

    y = np.asarray(module_path(x_ntvc))
    want = np.asarray(candidate_path(x_ntvc))
    return float(np.abs(y - want).max() / max(np.abs(want).max(), 1e-6))


def _auto_kwargs(n_batch):
    """models.autotune policy -> stacked_forward kwargs (the auto path
    resolved exactly as DSTDGCN resolves it at trace time)."""
    import jax.numpy as jnp

    from dstdgcn_tpu.models.autotune import resolve_auto

    r = resolve_auto(n_batch)
    return dict(
        dtype=None if r["compute_dtype"] is None else jnp.bfloat16,
        agg_group_s=r["agg_group_spatial"],
        agg_group_t=r["agg_group_temporal"])


def bench_shapes():
    """Forward chain at non-flagship shapes: large batch, CMU (V=25), 3DPW
    (V=23, T=40) and single-sequence serving; per shape the
    reference-style chain against f32, bf16, bf16+(5,2) and the "auto"
    policy (models/autotune.py) that the tuned configs ship."""
    import jax
    import jax.numpy as jnp

    rows = []
    shapes = [("b512_h36m", 512, 35, 22), ("b1024_h36m", 1024, 35, 22),
              ("b128_cmu_v25", 128, 35, 25),
              ("b128_3dpw_v23_t40", 128, 40, 23), ("b1_serving", 1, 35, 22)]
    for name, n, t, v in shapes:
        rng = np.random.RandomState(1)
        params = _naive_params(rng, 7, 64, t, v)
        x = jnp.asarray(rng.randn(n, t, v, 64).astype(np.float32))
        row = {"shape": name, "batch": n, "frames": t, "joints": v}
        row["ref_ms"] = round(median_ms(jax.jit(
            lambda xx: naive_reference_forward(params, xx)),
            jnp.transpose(x, (0, 3, 1, 2))), 4)
        candidates = {"bf16_g52": dict(dtype=jnp.bfloat16, agg_group_s=5,
                                       agg_group_t=2),
                      "bf16": dict(dtype=jnp.bfloat16), "f32": {},
                      "auto": _auto_kwargs(n)}
        for cname, kw in candidates.items():
            row[f"ours_ms_{cname}"] = round(median_ms(jax.jit(
                lambda xx, kw=kw: stacked_forward(params, xx, **kw)), x), 4)
        best = min((c for c in candidates if c != "auto"),
                   key=lambda c: row[f"ours_ms_{c}"])
        row["best_variant"] = best
        row["auto_matches_winner"] = (
            row["ours_ms_auto"] <= row[f"ours_ms_{best}"] * 1.1)
        row["speedup"] = round(row["ref_ms"] / row["ours_ms_auto"], 3)
        rows.append(row)
    return rows


def main():
    import jax
    import jax.numpy as jnp

    from dstdgcn_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    detail = RESULT["detail"]
    detail["device"] = device_record()
    peaks = device_peaks(detail["device"]["kind"])

    # flagship H36M shape
    n, t, v, c, blocks = 128, 35, 22, 64, 7
    rng = np.random.RandomState(0)
    params = _naive_params(rng, blocks, c, t, v)
    x_ntvc = jnp.asarray(rng.randn(n, t, v, c).astype(np.float32))
    x_nctv = jnp.transpose(x_ntvc, (0, 3, 1, 2))
    detail.update(batch=n, frames=t, joints=v, channels=c, blocks=blocks)

    # the timed candidate must compute the model's op
    detail["tether_rel_err_f32"] = tether_check(params, x_ntvc, "float32")
    detail["tether_rel_err_bf16"] = tether_check(params, x_ntvc, "bfloat16")
    detail["tether_ok"] = (detail["tether_rel_err_f32"] < 1e-4
                           and detail["tether_rel_err_bf16"] < 2e-2)

    t_naive = median_ms(jax.jit(
        lambda xx: naive_reference_forward(params, xx)), x_nctv)
    detail["step_ms_reference_style"] = round(t_naive, 4)
    candidates = {
        "xla": {}, "xla_bf16": dict(dtype=jnp.bfloat16),
        "xla_bd_bf16_g52": dict(dtype=jnp.bfloat16, agg_group_s=5,
                                agg_group_t=2)}
    for name, kw in candidates.items():
        detail[f"step_ms_{name}"] = round(median_ms(jax.jit(
            lambda xx, kw=kw: stacked_forward(params, xx, **kw)), x_ntvc), 4)
    best = min(candidates, key=lambda k: detail[f"step_ms_{k}"])
    t_ours = detail[f"step_ms_{best}"]
    flops = _flops_per_forward(n, t, v, c, blocks)
    detail["ours_variant"] = best
    detail["step_ms_ours"] = t_ours
    detail["achieved_tflops"] = round(flops / (t_ours * 1e-3) / 1e12, 3)
    detail["pct_of_bf16_peak"] = round(
        100 * flops / peaks["bf16_flops"] / (t_ours * 1e-3), 3)
    RESULT["value"] = round(_edges_per_forward(n, t, v, blocks)
                            / (t_ours * 1e-3), 1)
    RESULT["vs_baseline"] = (round(t_naive / t_ours, 4)
                             if detail["tether_ok"] else None)

    for key, nb, kw in (
            ("train_step_ms_b32", 32, {}),
            ("train_step_ms_b32_bd_bf16", 32,
             dict(compute_dtype="bfloat16", agg_group=(5, 2))),
            ("train_step_ms_b128", 128, {}),
            ("train_step_ms_b128_bd_bf16", 128,
             dict(compute_dtype="bfloat16", agg_group=(5, 2)))):
        detail[key] = round(bench_train_step(nb, **kw), 4)
    detail.update(bench_inference())
    detail["shapes"] = bench_shapes()
    _print_result(RESULT)


#: ordered priority of detail keys for the compact line — headline
#: metrics first; verbose structures (shapes) live only in the full record
_COMPACT_PRIORITY = (
    "ours_variant", "step_ms_ours", "achieved_tflops", "pct_of_bf16_peak",
    "train_step_ms_b128", "train_step_ms_b128_bd_bf16",
    "train_step_ms_b32", "train_step_ms_b32_bd_bf16",
    "infer_ms_standard", "infer_ms_standard_bd_bf16", "infer_seq_per_s",
    "tether_ok", "tether_rel_err_f32", "tether_rel_err_bf16",
    "step_ms_reference_style", "step_ms_xla", "step_ms_xla_bf16",
    "step_ms_xla_bd_bf16_g52", "device",
)

_FULL_RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "runs", "bench.json")


def _print_result(result, max_chars=1850):
    """Write the full record to ``_FULL_RECORD`` and print ONE compact
    JSON line (headline keys first, under ``max_chars``)."""
    os.makedirs(os.path.dirname(_FULL_RECORD), exist_ok=True)
    with open(_FULL_RECORD, "w") as f:
        json.dump(result, f, indent=1, sort_keys=True)
    detail = result.get("detail", {})
    compact = {k: result[k] for k in ("metric", "value", "unit",
                                      "vs_baseline") if k in result}
    compact["full_record"] = os.path.relpath(
        _FULL_RECORD, os.path.dirname(os.path.abspath(__file__)))
    cd = {}
    shapes = detail.get("shapes")
    if isinstance(shapes, list):
        cd["shape_speedups"] = {
            r["shape"]: r.get("speedup") for r in shapes if "shape" in r}
        auto_ok = [r.get("auto_matches_winner") for r in shapes
                   if "auto_matches_winner" in r]
        cd["auto_matches_winner_all"] = bool(auto_ok) and all(auto_ok)
    for k in _COMPACT_PRIORITY:
        if k in detail:
            cd[k] = detail[k]
        if len(json.dumps({**compact, "detail": cd})) > max_chars:
            cd.pop(k, None)
            break
    compact["detail"] = cd
    print(json.dumps(compact))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="DSTD-GC GPU benchmark")
    ap.add_argument("--autotune", action="store_true",
                    help="interleaved sweep of the auto-policy settings")
    args = ap.parse_args()
    if args.autotune:
        from dstdgcn_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()
        rec = device_record()
        print(json.dumps(dict(device=rec, autotune={
            k: v for k, v in autotune_sweep().items()})))
    else:
        main()
