"""DSTD-GCN motion-prediction network.

Reference architecture: ``/root/reference/model/dstdgcn.py:252-317`` (and the
channels-last "fast" variant, ``model/dstdgcn_fast.py:453-614``).  The model
consumes a padded position sequence ``(N, T=input_n+output_n, V, 3)`` whose
output frames were pre-filled with the last observed frame, forms a
(position, motion) 6-channel input, runs an in-layer + ``num_layers``
residual DSTD-GC encoder blocks + an out-layer, and adds back the last
observed frame so the network predicts motion deltas.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple, Union

import jax
import jax.numpy as jnp

from .autotune import resolve_knob
from .layers import JointBatchNorm, PReLU, STGCNNLayer, dropout

Array = jax.Array
Variables = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class DSTDGCN:
    """Flagship spatiotemporal motion-prediction model.

    Attributes mirror the reference constructor (dstdgcn.py:254-262); the
    extra knobs: ``fast`` selects the fully-learnable spatial adjacency +
    left-aggregation variant, ``bn_axis_name`` enables cross-replica
    BatchNorm statistics.

    ``init(key, x)`` returns ``{"params": ..., "batch_stats": ...}``;
    ``apply(variables, x, train=..., key=...)`` returns
    ``(out, new_batch_stats)`` (the statistics are returned unchanged in
    eval mode).  ``key`` feeds train-mode dropout.
    """

    input_channels: int = 6
    input_time_frame: int = 10
    output_time_frame: int = 25
    st_gcnn_dropout: float = 0.1
    joints_to_consider: int = 22
    num_feature: int = 64
    num_layers: int = 7
    layout: str = "h36m"
    fast: bool = False
    bn_axis_name: Optional[str] = None
    pair_flat: Union[bool, str] = False
    #: block-diagonal grouped aggregation sizes (must divide T / pad V);
    #: the string "auto" resolves per batch size at trace time
    #: (models/autotune.py)
    agg_group_spatial: Union[int, str, None] = None
    agg_group_temporal: Union[int, str, None] = None
    #: e.g. "bfloat16": mixed precision for the DSTD contractions (bf16
    #: inputs, f32 accumulation); params and outputs stay f32.  "auto"
    #: resolves per batch size (models/autotune.py)
    compute_dtype: Optional[str] = None
    #: jax.checkpoint every DSTD-GC op: True recomputes all
    #: intermediates in the backward (memory knob); "dots" saves matmul
    #: outputs and recomputes only the tanh-broadcast score tensor
    remat: Union[bool, str] = False
    #: configured batch size for "auto" knob resolution (set by the
    #: runner from train_batch_size): keeps the knob set constant across
    #: ragged final batches and eval shapes (models/autotune.py)
    auto_batch_hint: Optional[int] = None

    @property
    def time_dim(self) -> int:
        return self.input_time_frame + self.output_time_frame

    def _layers(self, batch: int):
        """The (in, encoders, out) STGCNN layers with "auto" knobs resolved
        for ``batch`` (a static shape under jit)."""
        hint = self.auto_batch_hint
        common = dict(
            time_dim=self.time_dim, joints_dim=self.joints_to_consider,
            layout=self.layout, fast=self.fast,
            bn_axis_name=self.bn_axis_name, pair_flat=self.pair_flat,
            compute_dtype=resolve_knob("compute_dtype", self.compute_dtype,
                                       batch, hint),
            agg_group_spatial=resolve_knob(
                "agg_group_spatial", self.agg_group_spatial, batch, hint),
            agg_group_temporal=resolve_knob(
                "agg_group_temporal", self.agg_group_temporal, batch, hint),
            remat=self.remat, refine=True)
        conv_in = STGCNNLayer(out_channels=self.num_feature, residual=False,
                              **common)
        encoder = STGCNNLayer(out_channels=self.num_feature, residual=True,
                              **common)
        conv_out = STGCNNLayer(out_channels=self.input_channels // 2,
                               residual=False, **common)
        return conv_in, encoder, conv_out

    def _check(self, x: Array) -> None:
        if x.shape[1:3] != (self.time_dim, self.joints_to_consider):
            raise ValueError(
                f"input {x.shape} does not match (N, {self.time_dim}, "
                f"{self.joints_to_consider}, C)")

    def init(self, key: Array, x: Array) -> Variables:
        """Parameters and BatchNorm statistics; ``x`` is a sample input
        whose shape is checked against the configuration."""
        self._check(x)
        conv_in, encoder, conv_out = self._layers(x.shape[0])
        bn, v, c = JointBatchNorm(), self.joints_to_consider, self.num_feature
        keys = jax.random.split(key, self.num_layers + 2)
        params, stats = {}, {}
        params["conv_st_in"], stats["conv_st_in"] = conv_in.init(
            keys[0], self.input_channels)
        params["bn_in"], stats["bn_in"] = bn.init(v, c)
        params["prelu"] = PReLU().init()
        for i in range(self.num_layers):
            params[f"encoder_{i}"], stats[f"encoder_{i}"] = encoder.init(
                keys[i + 1], c)
            params[f"encoder_bn_{i}"], stats[f"encoder_bn_{i}"] = \
                bn.init(v, c)
            params[f"encoder_prelu_{i}"] = PReLU().init()
        params["conv_st_out"], stats["conv_st_out"] = conv_out.init(
            keys[-1], c)
        return {"params": params, "batch_stats": stats}

    def apply(self, variables: Variables, x: Array, *, train: bool = False,
              key: Optional[Array] = None) -> Tuple[Array, Dict[str, Any]]:
        self._check(x)
        p, s = variables["params"], variables["batch_stats"]
        conv_in, encoder, conv_out = self._layers(x.shape[0])
        bn = JointBatchNorm(axis_name=self.bn_axis_name)
        new: Dict[str, Any] = {}

        # motion decomposition (dstdgcn.py:298-303): last padded frame is the
        # last observed frame; channels = (position, position - last)
        residual = x[:, -1:]
        h = jnp.concatenate([x, x - residual], axis=-1)

        h, new["conv_st_in"] = conv_in.apply(p["conv_st_in"], s["conv_st_in"],
                                             h, train=train)
        h, new["bn_in"] = bn.apply(p["bn_in"], s["bn_in"], h, train=train)
        h = PReLU().apply(p["prelu"], h)
        if train:
            h = dropout(h, self.st_gcnn_dropout, key)

        for i in range(self.num_layers):
            name, bn_name = f"encoder_{i}", f"encoder_bn_{i}"
            h, new[name] = encoder.apply(p[name], s[name], h, train=train)
            h, new[bn_name] = bn.apply(p[bn_name], s[bn_name], h, train=train)
            h = PReLU().apply(p[f"encoder_prelu_{i}"], h)

        h, new["conv_st_out"] = conv_out.apply(
            p["conv_st_out"], s["conv_st_out"], h, train=train)
        return h + residual, (new if train else s)


_REGISTRY = {
    "dstdgcn": dict(fast=False),
    "dstdgcn_fast": dict(fast=True),
}


def get_model(name: str, **opts: Any) -> DSTDGCN:
    """Model factory, parity with reference ``model/__init__.py:11-14``.

    ``opts`` follows the reference config convention: the model's own
    hyper-parameters live under ``opts[name]``.
    """
    if name not in _REGISTRY:
        raise ValueError(f"unknown model {name!r}")
    kwargs = dict(opts.get(name, {}))
    for k in ("name", "load", "ckpt"):
        kwargs.pop(k, None)
    kwargs.update(_REGISTRY[name])
    for k in ("bn_axis_name", "compute_dtype", "pair_flat",
              "agg_group_spatial", "agg_group_temporal", "remat",
              "auto_batch_hint"):
        if k in opts:
            kwargs[k] = opts[k]
    return DSTDGCN(**kwargs)
