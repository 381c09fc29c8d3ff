"""Functional building blocks for the DSTD-GCN family.

Channels-last ``(N, T, V, C)`` modules whose math matches the reference
PyTorch layers (``/root/reference/model/dstdgcn.py``) while being idiomatic
JAX: each module is a frozen dataclass of hyper-parameters with an
``init`` that builds its parameter (and BatchNorm statistic) subtrees as
nested dicts and an ``apply`` that is a pure function of them.  The
per-kernel Python loops of the reference become stacked kernel axes, and
everything composes under ``jit``/``shard_map``.

Stateful modules (those holding BatchNorm statistics) return
``(params, batch_stats)`` from ``init`` and ``(out, new_batch_stats)``
from ``apply``; stateless ones return ``params`` and ``out``.  The tree
paths (``conv_st_in/block/spatial/wf``, ``encoder_bn_0/scale`` ...) are
the ones the checkpoint format, ``utils/convert.py`` and the
``parallel/mesh.py`` sharding rules key on.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..graphs import skeleton as sk
from ..graphs import temporal as tg
from ..ops import dstd as ops

Array = jax.Array
Tree = Dict[str, Any]

_zeros = jax.nn.initializers.zeros
_ones = jax.nn.initializers.ones


def kaiming_out(fan_out: int) -> Callable:
    """Kaiming-normal (mode=fan_out, gain=sqrt(2)) matching torch
    ``nn.init.kaiming_normal_(w, mode='fan_out')`` for a 1x1 conv
    (reference dstdgcn.py:14-17).  ``fan_out`` is passed explicitly because
    our kernels carry a leading stacked-kernel axis."""
    return jax.nn.initializers.normal(stddev=float(np.sqrt(2.0 / fan_out)))


def uniform_pm(bound: float) -> Callable:
    """U(-bound, bound) init (torch ``.uniform_(-stdv, stdv)``)."""

    def init(key, shape, dtype=jnp.float32):
        return jax.random.uniform(key, shape, dtype, -bound, bound)

    return init


def _dense_init(key, cin: int, co: int) -> Tree:
    """``{"kernel": (cin, co), "bias": (co,)}`` of a channels-last dense
    projection (a 1x1 conv of the reference)."""
    return {"kernel": kaiming_out(co)(key, (cin, co), jnp.float32),
            "bias": _zeros(key, (co,), jnp.float32)}


def _dense(p: Tree, x: Array) -> Array:
    dtype = jnp.result_type(x, p["kernel"])
    y = jax.lax.dot_general(x.astype(dtype), p["kernel"].astype(dtype),
                            (((x.ndim - 1,), (0,)), ((), ())))
    return y + p["bias"].astype(dtype).reshape((1,) * (y.ndim - 1) + (-1,))


def dropout(x: Array, rate: float, key: Optional[Array]) -> Array:
    """Inverted dropout (torch ``nn.Dropout`` semantics); identity when
    ``rate`` is 0."""
    if rate == 0.0:
        return x
    if key is None:
        raise ValueError("train-mode dropout needs a PRNG key")
    keep = 1.0 - rate
    mask = jax.random.bernoulli(key, p=keep, shape=x.shape)
    return jax.lax.select(mask, x / keep, jnp.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class JointBatchNorm:
    """BatchNorm over (channel, joint) pairs across batch x time.

    Equivalent to the reference ``BatchNorm`` wrapper around
    ``nn.BatchNorm1d(C*V)`` on ``(N, C*V, T)`` (dstdgcn.py:35-50): every
    (c, v) feature is normalized over the N*T samples, with torch
    momentum/eps defaults and running statistics.

    Operates directly on channels-last (N, T, V, C) without the
    permute/reshape dance, and supports cross-replica statistics via
    ``axis_name`` (``pmean`` over a ``shard_map`` data axis) so distributed
    training reproduces single-device dynamics at the same global batch.
    """

    momentum: float = 0.1  # torch: new = (1 - m) * old + m * batch
    eps: float = 1e-5
    axis_name: Optional[str] = None
    dtype: Any = jnp.float32

    def init(self, v: int, c: int) -> Tuple[Tree, Tree]:
        params = {"scale": jnp.ones((v, c), jnp.float32),
                  "bias": jnp.zeros((v, c), jnp.float32)}
        stats = {"mean": jnp.zeros((v, c), jnp.float32),
                 "var": jnp.ones((v, c), jnp.float32)}
        return params, stats

    def apply(self, params: Tree, stats: Tree, x: Array, *,
              train: bool) -> Tuple[Array, Tree]:
        if train:
            xf = x.astype(jnp.float32)
            cnt = x.shape[0] * x.shape[1]
            mean = jnp.mean(xf, axis=(0, 1))
            mean_sq = jnp.mean(xf * xf, axis=(0, 1))
            if self.axis_name is not None:
                # cross-replica ("sync BN") statistics over the data axis
                mean = jax.lax.pmean(mean, self.axis_name)
                mean_sq = jax.lax.pmean(mean_sq, self.axis_name)
                cnt = cnt * jax.lax.psum(1, self.axis_name)
            var = mean_sq - mean * mean  # biased, used for normalization
            unbiased = var * (cnt / max(cnt - 1, 1))
            m = self.momentum
            stats = {"mean": (1 - m) * stats["mean"] + m * mean,
                     "var": (1 - m) * stats["var"] + m * unbiased}
        else:
            mean, var = stats["mean"], stats["var"]
        inv = jax.lax.rsqrt(var + self.eps) * params["scale"]
        return ((x - mean) * inv + params["bias"]).astype(self.dtype), stats


@dataclasses.dataclass(frozen=True)
class PReLU:
    """Single-parameter PReLU, torch default init 0.25 (dstdgcn.py:132)."""

    init_value: float = 0.25

    def init(self) -> Tree:
        return {"negative_slope": jnp.asarray(self.init_value, jnp.float32)}

    def apply(self, params: Tree, x: Array) -> Array:
        a = params["negative_slope"]
        return jnp.where(x >= 0, x, a.astype(x.dtype) * x)


@dataclasses.dataclass(frozen=True)
class DSTDGC:
    """Stacked Dynamic SpatioTemporal Decompose Graph Convolution.

    One module evaluates K reference ``DSTDGC`` units (dstdgcn.py:53-94) in
    a single batched contraction; the caller supplies the K static base
    adjacencies and the shared dynamic gate ``alpha``.
    """

    out_channels: int
    ref_len: int            # T for spatial mode, V for temporal mode
    num_kernels: int = 1
    red_channels: int = 2
    mode: str = "spatial"
    agg: str = "right"      # "right"=qualitative, "left"=fast variant
    compute_dtype: Optional[str] = None   # e.g. "bfloat16" (f32 accum)
    #: flat (P*P) pair layout (ops.dstd): True/False for both ops or
    #: 'spatial'/'temporal' for one side
    pair_flat: Union[bool, str] = False
    #: block-diagonal grouped aggregation (ops.dstd agg_group): packs g
    #: frames (spatial) / joints (temporal) per matmul
    agg_group: Optional[int] = None
    #: jax.checkpoint the op — a memory knob: True recomputes every
    #: intermediate (pairwise scores, projected features, dynamic
    #: adjacency) in the backward; "dots" saves the matmul outputs and
    #: recomputes only the elementwise tanh-broadcast score tensor
    remat: Union[bool, str] = False

    def __post_init__(self):
        if self.mode not in ("spatial", "temporal"):
            raise ValueError(f"mode={self.mode!r}")
        if self.pair_flat not in (True, False, "spatial", "temporal"):
            raise ValueError(
                f"pair_flat={self.pair_flat!r}: expected True, False, "
                "'spatial' or 'temporal'")

    def init(self, key: Array, cin: int) -> Tree:
        k, co = self.num_kernels, self.out_channels
        r, ref = self.red_channels, self.ref_len
        kf, k1, k2, kr = jax.random.split(key, 4)
        f32 = jnp.float32
        return {"wf": kaiming_out(co)(kf, (k, cin, co), f32),
                "bf": _zeros(kf, (k, co), f32),
                "wm1": kaiming_out(r)(k1, (k, cin, r), f32),
                "bm1": _zeros(k1, (k, r), f32),
                "wm2": kaiming_out(r)(k2, (k, cin, r), f32),
                "bm2": _zeros(k2, (k, r), f32),
                "wrm": kaiming_out(ref)(kr, (k, r, ref, ref), f32),
                "brm": _zeros(kr, (k, ref), f32)}

    def apply(self, params: Tree, x: Array, base_adj: Array, alpha: Array,
              mask: Optional[Array] = None) -> Array:
        p = params
        fn = ops.dstd_spatial if self.mode == "spatial" else ops.dstd_temporal
        dtype = (None if self.compute_dtype is None
                 else jnp.dtype(self.compute_dtype))
        call = functools.partial(
            fn, agg=self.agg, dtype=dtype,
            pair_flat=self.pair_flat in (True, self.mode),
            agg_group=self.agg_group)
        if self.remat == "dots":
            call = jax.checkpoint(
                call, policy=jax.checkpoint_policies.dots_saveable)
        elif self.remat:
            call = jax.checkpoint(call)
        return call(x, base_adj, alpha, p["wf"], p["bf"], p["wm1"], p["bm1"],
                    p["wm2"], p["bm2"], p["wrm"], p["brm"], mask)


@dataclasses.dataclass(frozen=True)
class DSTDGCB:
    """DSTD-GC block: spatial kernels + BN + residual + PReLU + temporal.

    Reference ``DSTDGCB`` (dstdgcn.py:97-163).  Static adjacency handling:

      * qualitative variant (default): the reference writes the effective
        spatial base as ``A_s[i] * W_s[i] + R_s[i]`` — but its
        ``R_s = nn.Parameter(torch.FloatTensor(self.A_s))`` (dstdgcn.py:109)
        ALIASES A_s's storage (torch.FloatTensor on a same-dtype tensor does
        not copy), so "fixed" A_s tracks every R_s update while autograd
        still treats the ``A_s * W_s`` factor as constant.  The exact
        semantics, reproduced here, are therefore
        ``stop_gradient(R_s) * W_s + R_s`` with ``W_s`` a learnable gate
        (init 0) and ``R_s`` learnable (init = the adjacency stack; the
        reference never calls its re-init, dstdgcn.py:135-139);
      * fast variant (dstdgcn_fast.py:175): a single fully-learnable ``A_s``
        initialized to the adjacency stack.

    Temporal base is ``A_t + R_t`` with fixed ``A_t`` (the reference's
    quirky "neighboor" matrix, see graphs/temporal.py) and learnable ``R_t``
    (init 0); A_t does NOT alias R_t (it is built from numpy, which copies).
    """

    out_channels: int
    time_dim: int
    joint_dim: int
    layout: str = "h36m"
    fast: bool = False
    bn_axis_name: Optional[str] = None
    compute_dtype: Optional[str] = None
    pair_flat: Union[bool, str] = False
    agg_group_spatial: Optional[int] = None
    agg_group_temporal: Optional[int] = None
    remat: Union[bool, str] = False

    def _parts(self):
        a_s = sk.stacked_adjacency(self.layout)            # (2, V, V)
        a_t = tg.stacked_adjacency(self.time_dim)          # (1, T, T)
        agg = "left" if self.fast else "right"
        common = dict(out_channels=self.out_channels, agg=agg,
                      compute_dtype=self.compute_dtype,
                      pair_flat=self.pair_flat, remat=self.remat)
        spatial = DSTDGC(ref_len=self.time_dim, num_kernels=a_s.shape[0],
                         mode="spatial", agg_group=self.agg_group_spatial,
                         **common)
        temporal = DSTDGC(ref_len=self.joint_dim, num_kernels=a_t.shape[0],
                          mode="temporal", agg_group=self.agg_group_temporal,
                          **common)
        act_dtype = (jnp.float32 if self.compute_dtype is None
                     else jnp.dtype(self.compute_dtype))
        bn = JointBatchNorm(axis_name=self.bn_axis_name, dtype=act_dtype)
        return a_s, a_t, spatial, temporal, bn

    def init(self, key: Array, cin: int) -> Tuple[Tree, Tree]:
        a_s, a_t, spatial, temporal, bn = self._parts()
        assert a_s.shape[1] == self.joint_dim, (a_s.shape, self.joint_dim)
        co, v = self.out_channels, self.joint_dim
        k_res, k_s, k_t = jax.random.split(key, 3)
        a_s = jnp.asarray(a_s, jnp.float32)
        params: Tree = ({"A_s": a_s} if self.fast else
                        {"W_s": jnp.zeros(a_s.shape, jnp.float32),
                         "R_s": a_s})
        params["R_t"] = jnp.zeros(a_t.shape, jnp.float32)
        params["alpha_sm"] = jnp.zeros((1,), jnp.float32)
        params["alpha_tm"] = jnp.zeros((1,), jnp.float32)
        stats: Tree = {}
        if cin != co:
            params["residual_proj"] = _dense_init(k_res, cin, co)
            params["residual_bn"], stats["residual_bn"] = bn.init(v, co)
        params["spatial"] = spatial.init(k_s, cin)
        params["bn"], stats["bn"] = bn.init(v, co)
        params["prelu"] = PReLU().init()
        params["temporal"] = temporal.init(k_t, co)
        return params, stats

    def apply(self, params: Tree, stats: Tree, x: Array, *,
              train: bool) -> Tuple[Array, Tree]:
        _, a_t, spatial, temporal, bn = self._parts()
        assert x.shape[1] == self.time_dim and x.shape[2] == self.joint_dim
        p, new = params, {}
        if self.fast:
            base_s = p["A_s"]
        else:
            base_s = jax.lax.stop_gradient(p["R_s"]) * p["W_s"] + p["R_s"]
        base_t = jnp.asarray(a_t) + p["R_t"]

        if "residual_proj" in p:
            res = _dense(p["residual_proj"], x)
            res, new["residual_bn"] = bn.apply(
                p["residual_bn"], stats["residual_bn"], res, train=train)
        else:
            res = x
        y = spatial.apply(p["spatial"], x, base_s, p["alpha_sm"])
        y, new["bn"] = bn.apply(p["bn"], stats["bn"], y, train=train)
        y = PReLU().apply(p["prelu"], y + res)
        z = temporal.apply(p["temporal"], y, base_t, p["alpha_tm"])
        return z, new


@dataclasses.dataclass(frozen=True)
class ConvTemporalGraphical:
    """Legacy ST-GCN unit (reference dstdgcn.py:166-188).

    Dead in the shipped DSTD-GCN configs (all layers use refine=True) but
    part of the capability surface: learnable per-joint temporal mixing
    ``T (V, T, T)`` followed by per-frame joint mixing ``A (T, V, V)`` plus
    the fixed skeleton adjacency.
    """

    time_dim: int
    joints_dim: int
    layout: str = "h36m"

    def init(self, key: Array) -> Tree:
        t, v = self.time_dim, self.joints_dim
        ka, kt = jax.random.split(key)
        return {"A": uniform_pm(1.0 / np.sqrt(v))(ka, (t, v, v)),
                "T": uniform_pm(1.0 / np.sqrt(t))(kt, (v, t, t))}

    def apply(self, params: Tree, x: Array) -> Array:
        a_fixed = jnp.asarray(sk.adjacency(self.layout, "all"))[None]
        # reference: einsum('nctv,vtq->ncqv') then einsum('nctv,tvw->nctw')
        y = jnp.einsum("ntvc,vtq->nqvc", x, params["T"],
                       preferred_element_type=jnp.float32)
        return jnp.einsum("ntvc,tvw->ntwc", y, params["A"] + a_fixed,
                          preferred_element_type=jnp.float32)


@dataclasses.dataclass(frozen=True)
class STGCNNLayer:
    """Refine-or-legacy spatiotemporal layer (reference dstdgcn.py:191-249)."""

    out_channels: int
    time_dim: int
    joints_dim: int
    kernel_size: Tuple[int, int] = (1, 1)
    stride: int = 1
    refine: bool = True
    residual: bool = True
    layout: str = "h36m"
    fast: bool = False
    bn_axis_name: Optional[str] = None
    compute_dtype: Optional[str] = None
    pair_flat: Union[bool, str] = False
    agg_group_spatial: Optional[int] = None
    agg_group_temporal: Optional[int] = None
    remat: Union[bool, str] = False

    def _block(self) -> DSTDGCB:
        return DSTDGCB(out_channels=self.out_channels, time_dim=self.time_dim,
                       joint_dim=self.joints_dim, layout=self.layout,
                       fast=self.fast, bn_axis_name=self.bn_axis_name,
                       compute_dtype=self.compute_dtype,
                       pair_flat=self.pair_flat,
                       agg_group_spatial=self.agg_group_spatial,
                       agg_group_temporal=self.agg_group_temporal,
                       remat=self.remat)

    def _tgcn(self) -> ConvTemporalGraphical:
        return ConvTemporalGraphical(self.time_dim, self.joints_dim,
                                     self.layout)

    def init(self, key: Array, cin: int) -> Tuple[Tree, Tree]:
        co = self.out_channels
        k_res, k_body, k_conv = jax.random.split(key, 3)
        params: Tree = {}
        stats: Tree = {}
        if self.residual and (self.stride != 1 or cin != co):
            params["residual_proj"] = _dense_init(k_res, cin, co)
        if self.refine:
            params["block"], stats["block"] = self._block().init(k_body, cin)
        else:
            kh, kw = self.kernel_size
            params["tgcn"] = self._tgcn().init(k_body)
            params["conv"] = {
                "kernel": kaiming_out(co * kh * kw)(
                    k_conv, (kh, kw, cin, co), jnp.float32),
                "bias": jnp.zeros((co,), jnp.float32)}
        return params, stats

    def apply(self, params: Tree, stats: Tree, x: Array, *,
              train: bool) -> Tuple[Array, Tree]:
        new: Tree = {}
        res = None
        if self.residual:
            res = (_dense(params["residual_proj"], x)
                   if "residual_proj" in params else x)
        if self.refine:
            y, new["block"] = self._block().apply(
                params["block"], stats["block"], x, train=train)
        else:
            y = self._tgcn().apply(params["tgcn"], x)
            y = jax.lax.conv_general_dilated(
                y, params["conv"]["kernel"], (self.stride, self.stride),
                "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
            y = y + params["conv"]["bias"]
        if res is not None:
            y = y + res
        return y, new
