"""Reference-checkpoint migration: torch DSTD-GCN state_dict -> our params.

Lets users of the reference PyTorch implementation
(``/root/reference/model/dstdgcn.py``) load their trained checkpoints into
this framework.  Operates on ``{name: np.ndarray}`` dicts so torch is only
needed to *read* a ``.pth`` file (see :func:`load_torch_state_dict`).

Name mapping (torch -> our parameter tree):
  conv_st_in.stgcn.0.0         -> conv_st_in/block        (DSTDGCB)
  encoders.{i}.0.stgcn.0.0     -> encoder_{i}/block
  encoders.{i}.1 / .2          -> encoder_bn_{i} / encoder_prelu_{i}
  conv_st_out.stgcn.0.0        -> conv_st_out/block
  bn_in / prelu                -> bn_in / prelu

Within a DSTDGCB, the K per-kernel ``conv_s.{k}`` / ``conv_t.{k}`` units are
stacked along a leading kernel axis; 1x1 conv weights ``(Co, Ci, 1, 1)``
become dense kernels ``(Ci, Co)``; ``conv_rm`` weights ``(ref, R*ref, 1, 1)``
become ``(R, ref, ref)``; BatchNorm1d(C*V) vectors reshape to ``(V, C)``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

__all__ = ["torch_state_to_params", "load_torch_state_dict"]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a reference checkpoint (``.pth``) into numpy arrays.

    Accepts either a bare model state_dict or the engine checkpoint dict
    ``{lr, err, model, optimizer, scheduler, epoch}`` written by the
    reference engine (engine/prediction.py:171-182); the wrapper prefix
    ``model.`` added by the reference ModelWrapper is stripped.
    """
    try:
        import torch  # optional: only checkpoint migration needs it
    except ImportError as e:
        raise ImportError("reading a reference .pth checkpoint needs "
                          f"torch, which is not installed ({e})") from e

    state = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(state, dict) and "model" in state and not hasattr(
            state["model"], "shape"):
        state = state["model"]
    out = {}
    for k, v in state.items():
        if k.startswith("model."):
            k = k[len("model."):]
        if hasattr(v, "numpy"):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def _conv1x1(w: np.ndarray) -> np.ndarray:
    """(Co, Ci, 1, 1) conv weight -> (Ci, Co) dense kernel."""
    if w.ndim == 4:
        w = w[:, :, 0, 0]
    return np.ascontiguousarray(w.T)


def _rm(w: np.ndarray, red: int = 2) -> np.ndarray:
    """conv_rm weight (ref, R*ref, 1, 1) -> (R, ref_in, ref_out)."""
    if w.ndim == 4:
        w = w[:, :, 0, 0]
    ref_out, rin = w.shape
    ref_in = rin // red
    # w[t, r*ref_in + s] -> wrm[r, s, t]
    return np.ascontiguousarray(
        w.reshape(ref_out, red, ref_in).transpose(1, 2, 0))


def _bn_vec(v: np.ndarray, joints: int, fast: bool = False) -> np.ndarray:
    """BatchNorm1d(C*V) vector -> (V, C).

    The qualitative model flattens c-major (index c*V + v,
    dstdgcn.py:41-47); the fast model flattens v-major (index v*C + c,
    dstdgcn_fast.py:47-53)."""
    if fast:
        return np.ascontiguousarray(v.reshape(joints, -1))
    c = v.shape[0] // joints
    return np.ascontiguousarray(v.reshape(c, joints).T)


def _dstdgc(sd: Dict[str, np.ndarray], prefix: str, n_kernels: int,
            red: int = 2) -> Dict[str, np.ndarray]:
    def stack(name, conv):
        return np.stack([conv(sd[f"{prefix}.{k}.{name}"])
                         for k in range(n_kernels)])

    return {
        "wf": stack("conv_f.weight", _conv1x1),
        "bf": stack("conv_f.bias", np.asarray),
        "wm1": stack("conv_m1.weight", _conv1x1),
        "bm1": stack("conv_m1.bias", np.asarray),
        "wm2": stack("conv_m2.weight", _conv1x1),
        "bm2": stack("conv_m2.bias", np.asarray),
        "wrm": stack("conv_rm.weight", lambda w: _rm(w, red)),
        "brm": stack("conv_rm.bias", np.asarray),
    }


def _bn(sd, prefix, joints, fast=False):
    params = {"scale": _bn_vec(sd[f"{prefix}.bn.weight"], joints, fast),
              "bias": _bn_vec(sd[f"{prefix}.bn.bias"], joints, fast)}
    stats = {"mean": _bn_vec(sd[f"{prefix}.bn.running_mean"], joints, fast),
             "var": _bn_vec(sd[f"{prefix}.bn.running_var"], joints, fast)}
    return params, stats


def _block(sd: Dict[str, np.ndarray], tprefix: str, joints: int,
           fast: bool) -> tuple[dict, dict]:
    """Convert one DSTDGCB (torch prefix ``tprefix``)."""
    ks = 1 if fast else None
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    if fast:
        params["A_s"] = sd[f"{tprefix}.A_s"]
        n_s = params["A_s"].shape[0]
    else:
        params["W_s"] = sd[f"{tprefix}.W_s"]
        params["R_s"] = sd[f"{tprefix}.R_s"]
        n_s = params["W_s"].shape[0]
    params["R_t"] = sd[f"{tprefix}.R_t"]
    n_t = params["R_t"].shape[0]
    params["alpha_sm"] = sd[f"{tprefix}.alpha_sm"]
    params["alpha_tm"] = sd[f"{tprefix}.alpha_tm"]
    params["spatial"] = _dstdgc(sd, f"{tprefix}.conv_s", n_s)
    params["temporal"] = _dstdgc(sd, f"{tprefix}.conv_t", n_t)
    bn_p, bn_s = _bn(sd, f"{tprefix}.bn", joints, fast)
    params["bn"], stats["bn"] = bn_p, bn_s
    params["prelu"] = {"negative_slope": sd[f"{tprefix}.prelu.weight"]
                       .reshape(())}
    if f"{tprefix}.residual.0.weight" in sd:
        params["residual_proj"] = {
            "kernel": _conv1x1(sd[f"{tprefix}.residual.0.weight"]),
            "bias": sd[f"{tprefix}.residual.0.bias"],
        }
        rp, rs = _bn(sd, f"{tprefix}.residual.1", joints, fast)
        params["residual_bn"], stats["residual_bn"] = rp, rs
    return params, stats


def torch_state_to_params(sd: Dict[str, np.ndarray], num_layers: int,
                          joints: int, fast: bool = False) -> Dict[str, Any]:
    """Build ``{"params": ..., "batch_stats": ...}`` from a reference
    state_dict (numpy arrays)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def put(name, tprefix):
        p, s = _block(sd, tprefix, joints, fast)
        params[name] = {"block": p}
        if s:
            stats[name] = {"block": s}

    put("conv_st_in", "conv_st_in.stgcn.0.0")
    for i in range(num_layers):
        put(f"encoder_{i}", f"encoders.{i}.0.stgcn.0.0")
        pfx = f"encoders.{i}.1.bn"
        bnp = {"scale": _bn_vec(sd[f"{pfx}.weight"], joints, fast),
               "bias": _bn_vec(sd[f"{pfx}.bias"], joints, fast)}
        bns = {"mean": _bn_vec(sd[f"{pfx}.running_mean"], joints, fast),
               "var": _bn_vec(sd[f"{pfx}.running_var"], joints, fast)}
        params[f"encoder_bn_{i}"] = bnp
        stats[f"encoder_bn_{i}"] = bns
        params[f"encoder_prelu_{i}"] = {
            "negative_slope": sd[f"encoders.{i}.2.weight"].reshape(())}
    put("conv_st_out", "conv_st_out.stgcn.0.0")

    params["bn_in"] = {
        "scale": _bn_vec(sd["bn_in.bn.weight"], joints, fast),
        "bias": _bn_vec(sd["bn_in.bn.bias"], joints, fast)}
    stats["bn_in"] = {
        "mean": _bn_vec(sd["bn_in.bn.running_mean"], joints, fast),
        "var": _bn_vec(sd["bn_in.bn.running_var"], joints, fast)}
    params["prelu"] = {"negative_slope": sd["prelu.weight"].reshape(())}

    import jax.numpy as jnp
    # copy=True is load-bearing: several converted arrays (e.g. the fast
    # variant's v-major _bn_vec reshape) are zero-copy VIEWS of the torch
    # state_dict buffers, and jnp.asarray on the CPU backend can alias
    # host numpy memory — without the copy, running the torch model in
    # train mode afterwards silently mutates our batch_stats in place.
    to_jnp = lambda t: jnp.asarray(np.array(t, dtype=np.float32, copy=True))
    import jax
    return {"params": jax.tree.map(to_jnp, params),
            "batch_stats": jax.tree.map(to_jnp, stats)}
