"""Device mesh construction and sharding rules.

The framework's parallelism model (SURVEY.md §2.6), built on
``jax.sharding`` + GSPMD rather than hand-written DDP machinery (the
reference has none anyway); XLA:GPU lowers the collectives to NCCL:

  * ``data`` axis: batch (data parallel) — batches sharded on axis 0,
    parameters replicated, gradients all-reduced by XLA;
  * ``graph`` axis: spatiotemporal-graph partition — the joint (V) axis of
    activations is sharded, so per-frame joint aggregation becomes local
    partial contractions + an XLA-inserted reduce-scatter/all-gather pair
    (edge partitioning; see parallel/shard.py for the explicit shard_map
    formulation);
  * ``model`` axis (optional, SURVEY §2.6 "TP"): feature channels — the
    output dim of every projection weight and the channel dim of
    activations are sharded, so each device holds a column slice of the
    dense kernels and XLA inserts the all-reduce on the row-parallel
    contractions.  C=64 is small, so this is off unless
    ``parallel: {model: k}`` asks for it.

Under ``jit`` all arrays are global; ``jnp.mean`` over batch/time in
BatchNorm is automatically the *global* mean, so distributed training
preserves single-device semantics at the same global batch size.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "batch_sharding", "replicated", "activation_spec",
           "activation_sharding_context", "constrain_activation",
           "param_sharding"]


def make_mesh(data: Optional[int] = None, graph: int = 1, model: int = 1,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ("data", "graph"[, "model"]) mesh over the devices.

    The ``model`` axis is only materialized when > 1, so 2-axis users
    (shard_map edge partitioning) are unaffected."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        assert n % (graph * model) == 0, (n, graph, model)
        data = n // (graph * model)
    assert data * graph * model <= n
    if model > 1:
        arr = np.asarray(devices[:data * graph * model]).reshape(
            data, graph, model)
        return Mesh(arr, axis_names=("data", "graph", "model"))
    arr = np.asarray(devices[:data * graph]).reshape(data, graph)
    return Mesh(arr, axis_names=("data", "graph"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard axis 0 (batch) over the data axis; replicate the rest."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def _model_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1) if "model" in mesh.axis_names else 1


def activation_spec(mesh: Optional[Mesh] = None) -> P:
    """(N, T, V, C) activations: batch over data, joints over graph,
    channels over model (when that axis exists)."""
    if mesh is not None and _model_size(mesh) > 1:
        return P("data", None, "graph", "model")
    return P("data", None, "graph", None)


# parameters whose LAST dim is the feature/output-channel dim: the DSTD
# feature transform, Dense kernels/biases, and joint-BN (V, C) vectors
_CHANNEL_LAST_PARAMS = frozenset(
    ["wf", "bf", "kernel", "bias", "scale", "mean", "var"])


def param_sharding(mesh: Mesh, tree):
    """Per-leaf shardings for the optional tensor-parallel ``model`` axis.

    Column-parallel rule: parameters whose last dim is the feature/output
    channel (by leaf name — wf/bf/kernel/bias/scale and the BN statistics)
    get that dim sharded over ``model`` when divisible; everything else —
    tiny q/k heads (R=2), mixing weights, adjacencies, scalars —
    replicates.  Works on any pytree whose leaf paths end in the parameter
    names (params, batch_stats, Adam moments).  Without a model axis
    everything replicates (plain DP/graph sharding).
    """
    m = _model_size(mesh)

    def rule(path, leaf):
        key = getattr(path[-1], "key", getattr(path[-1], "name", ""))
        if m > 1 and str(key) in _CHANNEL_LAST_PARAMS \
                and hasattr(leaf, "ndim") and leaf.ndim >= 1 \
                and leaf.shape[-1] % m == 0:
            spec = P(*([None] * (leaf.ndim - 1) + ["model"]))
            return NamedSharding(mesh, spec)
        return replicated(mesh)

    return jax.tree_util.tree_map_with_path(rule, tree)


def place_tree(tree, shardings):
    """Place a host-resident pytree onto per-leaf (possibly multi-process)
    shardings.

    ``jax.device_put`` only accepts fully-addressable shardings, so under
    a real multi-host launch (jax.distributed, mesh spanning processes)
    placing the replicated/TP-sharded model + optimizer state needs
    ``jax.make_array_from_callback`` — every process holds the same host
    values (same init seed), and each addressable shard reads its slice.
    Typed PRNG keys can't round-trip through numpy, so they are placed as
    raw key data and re-wrapped on device.  Single-process meshes keep
    the plain device_put fast path.  (Found by the round-5 two-process
    CPU launch: device_put raised on the non-addressable sharding.)
    """
    def place(x, sh):
        if getattr(sh, "is_fully_addressable", True):
            return jax.device_put(x, sh)
        if hasattr(x, "dtype") and jax.dtypes.issubdtype(
                x.dtype, jax.dtypes.prng_key):
            impl = jax.random.key_impl(x)
            kd = np.asarray(jax.random.key_data(x))
            kd_sh = NamedSharding(sh.mesh, P(*(tuple(sh.spec) + (None,))))
            gkd = jax.make_array_from_callback(kd.shape, kd_sh,
                                               lambda idx: kd[idx])
            return jax.jit(
                lambda d: jax.random.wrap_key_data(d, impl=impl),
                out_shardings=sh)(gkd)
        xh = np.asarray(x)
        return jax.make_array_from_callback(xh.shape, sh,
                                            lambda idx: xh[idx])

    return jax.tree.map(place, tree, shardings)


# -- activation-constraint context -----------------------------------------
# ops.dstd consults this so model code stays mesh-agnostic: under a mesh
# context every (N, T, V, C) activation is pinned to the edge-partitioned
# layout, forcing GSPMD to keep the graph dimension sharded through the
# SDDMM/SpMM chain instead of rematerializing it replicated.

_ACTIVE_MESH: contextvars.ContextVar[Optional[Mesh]] = \
    contextvars.ContextVar("dstdgcn_active_mesh", default=None)


@contextlib.contextmanager
def activation_sharding_context(mesh: Optional[Mesh]):
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield
    finally:
        _ACTIVE_MESH.reset(token)


def constrain_activation(x: jax.Array) -> jax.Array:
    """Apply the (data, -, graph, -[, model]) constraint if a mesh is
    active and the array is a 4D (N, T, V, C) activation."""
    mesh = _ACTIVE_MESH.get()
    if mesh is None or x.ndim != 4:
        return x
    return jax.lax.with_sharding_constraint(
        x, NamedSharding(mesh, activation_spec(mesh)))
