"""Explicit edge-partitioned DSTD-GC via ``shard_map`` + XLA collectives.

The hand-written formulation of the north-star parallelism (BASELINE.json):
the spatiotemporal graph's joint axis is partitioned across the ``graph``
mesh axis, and the two communication points are explicit:

  * spatial kernel: the correlation *keys* (a tiny ``(K, N, T, V, R=2)``
    tensor) are all-gathered (NCCL over NVLink), every shard computes the
    pairwise scores / dynamic adjacency / aggregation for its local source
    joints against all destination joints, and the result is combined with a
    ``psum_scatter`` over destination joints — a reduce-scatter that
    overlaps with the next kernel's compute under XLA's scheduler;
  * temporal kernel: scores are joint-local; only the joint-mixing of the
    dynamic adjacency needs the same partial-contraction + ``psum_scatter``.

Semantically identical to :mod:`dstdgcn_tpu.ops.dstd` (golden-tested on a
virtual CPU mesh); the GSPMD path (parallel/mesh.py) derives the same
program automatically — this module exists for explicit control of the
collective schedule.

:func:`dstd_spatial_ring` is the explicitly OVERLAPPED schedule (the
north-star "edge-partitioned, all-to-all overlapped" config,
BASELINE.json): instead of one upfront ``all_gather`` + one bulk compute,
the (query, feature) chunks rotate around the ``graph`` ring with
``ppermute`` while each round's partial scores/aggregation are computed —
every round's send is independent of that round's math, so XLA:GPU's
asynchronous collectives (``collective-permute-start``/``-done`` over
NCCL) can hide the NVLink transfer behind the matmuls;
``hlo_check.check_overlap`` reads the compiled schedule to confirm it.
Per-pair semantics are identical to
:func:`dstd_spatial_edge_partitioned` (each (source, destination) joint
pair is visited exactly once across rounds).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # jax>=0.4.35 top-level export
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

__all__ = ["dstd_spatial_edge_partitioned", "dstd_temporal_edge_partitioned",
           "dstd_spatial_ring"]

AXIS = "graph"


def _local_project(x, w, b):
    y = jnp.einsum("ntvc,kcd->kntvd", x, w,
                   preferred_element_type=jnp.float32)
    return y + b[:, None, None, None, :]


def dstd_spatial_edge_partitioned(mesh: Mesh, x, base_adj, alpha,
                                  wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                                  batch_sharded: bool = False):
    """Spatial DSTD-GC with the joint axis sharded over ``graph``.

    x: global (N, T, V, Ci); V must divide the graph-axis size.  Returns the
    global (N, T, V, Co), sharded the same way.
    """
    nshard = mesh.shape[AXIS]
    v = x.shape[2]
    assert v % nshard == 0, (v, nshard)
    v_loc = v // nshard

    def kernel(x_l, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm):
        # x_l: (N, T, V_loc, Ci); weights replicated
        idx = jax.lax.axis_index(AXIS)
        q = _local_project(x_l, wm1, bm1)             # (K,N,T,V_loc,R)
        k = _local_project(x_l, wm2, bm2)
        # halo exchange: destination-side keys for every shard (tiny tensor)
        k_full = jax.lax.all_gather(k, AXIS, axis=3, tiled=True)
        # scores for local source joints vs ALL destination joints
        s = jnp.tanh(q[..., :, None, :] - k_full[..., None, :, :])
        s = jnp.moveaxis(s, -1, -3)                   # (K,N,T,R,V_loc,V)
        dyn = jnp.einsum("knsrvw,krst->kntvw", s, wrm,
                         preferred_element_type=jnp.float32)
        dyn = dyn + brm[:, None, :, None, None]
        base_rows = jax.lax.dynamic_slice_in_dim(base, idx * v_loc, v_loc,
                                                 axis=1)  # (K,V_loc,V)
        adj = dyn * alpha + base_rows[:, None, None, :, :]
        xf = _local_project(x_l, wf, bf)              # (K,N,T,V_loc,Co)
        # partial aggregation over local sources, for all destinations
        part = jnp.einsum("kntvc,kntvw->ntwc", xf, adj,
                          preferred_element_type=jnp.float32)
        # reduce-scatter destinations back onto the graph axis
        return jax.lax.psum_scatter(part, AXIS, scatter_dimension=2,
                                    tiled=True)

    spec_x = _x_spec(mesh, batch_sharded)
    rep = P()
    return shard_map(
        kernel, mesh=mesh,
        in_specs=(spec_x, rep, rep, rep, rep, rep, rep, rep, rep, rep, rep),
        out_specs=spec_x,
    )(x, base_adj, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm)


def dstd_spatial_ring(mesh: Mesh, x, base_adj, alpha,
                      wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                      batch_sharded: bool = False):
    """Ring-pipelined spatial DSTD-GC (overlapped halo exchange).

    Joint axis sharded over ``graph``; each shard owns a destination block
    and accumulates its output over ``nshard`` rounds.  Round ``r`` computes
    the (source-chunk ``(i - r) mod n``, local destinations) partial while
    ``ppermute`` forwards the (q, xf) chunk to the next shard — the
    communication of round ``r+1`` rides NVLink underneath round ``r``'s
    score/mixing/aggregation matmuls.  Matches
    :func:`dstd_spatial_edge_partitioned` bit-for-math (same contractions,
    chunked); golden-tested against ops.dstd on the CPU mesh.

    Reference anchor: the aggregation being sharded is
    /root/reference/model/dstdgcn.py:87 (``einsum nctv,ntvw->nctw``) with
    the dynamic adjacency of :82-86.
    """
    nshard = mesh.shape[AXIS]
    v = x.shape[2]
    assert v % nshard == 0, (v, nshard)
    v_loc = v // nshard
    ring = [(i, (i + 1) % nshard) for i in range(nshard)]

    def kernel(x_l, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm):
        idx = jax.lax.axis_index(AXIS)
        # local projections: keys stay put (destination side); the query
        # and feature chunks travel the ring (source side)
        k_loc = _local_project(x_l, wm2, bm2)         # (K,N,T,V_loc,R)
        q_chunk = _local_project(x_l, wm1, bm1)
        xf_chunk = _local_project(x_l, wf, bf)        # (K,N,T,V_loc,Co)
        base_cols = jax.lax.dynamic_slice_in_dim(
            base, idx * v_loc, v_loc, axis=2)         # (K,V,V_loc)
        out = jnp.zeros(x_l.shape[:3] + (wf.shape[-1],), jnp.float32)

        for r in range(nshard):
            # start forwarding the current chunk; XLA schedules the
            # ppermute asynchronously so it overlaps this round's compute
            if r + 1 < nshard:
                q_next = jax.lax.ppermute(q_chunk, AXIS, ring)
                xf_next = jax.lax.ppermute(xf_chunk, AXIS, ring)
            # source rows this chunk corresponds to: shard (idx - r) mod n
            src = (idx - r) % nshard
            s = jnp.tanh(q_chunk[..., :, None, :]
                         - k_loc[..., None, :, :])    # (K,N,T,Vc,Vl,R)
            s = jnp.moveaxis(s, -1, -3)               # (K,N,T,R,Vc,Vl)
            dyn = jnp.einsum("knsrvw,krst->kntvw", s, wrm,
                             preferred_element_type=jnp.float32)
            dyn = dyn + brm[:, None, :, None, None]
            rows = jax.lax.dynamic_slice_in_dim(base_cols, src * v_loc,
                                                v_loc, axis=1)  # (K,Vc,Vl)
            adj = dyn * alpha + rows[:, None, None, :, :]
            out = out + jnp.einsum("kntvc,kntvw->ntwc", xf_chunk, adj,
                                   preferred_element_type=jnp.float32)
            if r + 1 < nshard:
                q_chunk, xf_chunk = q_next, xf_next
        return out

    spec_x = _x_spec(mesh, batch_sharded)
    rep = P()
    return shard_map(
        kernel, mesh=mesh,
        in_specs=(spec_x, rep, rep, rep, rep, rep, rep, rep, rep, rep, rep),
        out_specs=spec_x,
    )(x, base_adj, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm)


def _x_spec(mesh: Mesh, batch_sharded: bool) -> P:
    """(N, T, V, C) spec.  With ``batch_sharded`` the batch axis is split
    over ``data`` too (the kernels are batch-local, so data-parallel
    composes for free); default replicates batch for small-array tests."""
    batch = "data" if batch_sharded and "data" in mesh.axis_names else None
    return P(batch, None, AXIS, None)


def dstd_temporal_edge_partitioned(mesh: Mesh, x, base_adj, alpha,
                                   wf, bf, wm1, bm1, wm2, bm2, wrm, brm,
                                   batch_sharded: bool = False):
    """Temporal DSTD-GC with the joint axis sharded over ``graph``.

    Pairwise frame scores are joint-local; the joint-mixing ``wrm``
    contraction is the only cross-shard reduction (psum_scatter over output
    joints).  x: global (N, T, V, Ci) -> (N, T, V, Co).
    """
    nshard = mesh.shape[AXIS]
    v = x.shape[2]
    assert v % nshard == 0, (v, nshard)
    v_loc = v // nshard

    def kernel(x_l, base, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm):
        idx = jax.lax.axis_index(AXIS)
        q = _local_project(x_l, wm1, bm1)             # (K,N,T,V_loc,R)
        k = _local_project(x_l, wm2, bm2)
        qt = jnp.swapaxes(q, 2, 3)                    # (K,N,V_loc,T,R)
        kt = jnp.swapaxes(k, 2, 3)
        s = jnp.tanh(qt[..., :, None, :] - kt[..., None, :, :])
        s = jnp.moveaxis(s, -1, -3)                   # (K,N,V_loc,R,T,T)
        # joint-mixing: local source joints contribute to ALL output joints
        wrm_rows = jax.lax.dynamic_slice_in_dim(wrm, idx * v_loc, v_loc,
                                                axis=2)  # (K,R,V_loc,V)
        part = jnp.einsum("knvrtu,krvw->knwtu", s, wrm_rows,
                          preferred_element_type=jnp.float32)
        dyn = jax.lax.psum_scatter(part, AXIS, scatter_dimension=2,
                                   tiled=True)        # (K,N,V_loc,T,T)
        brm_loc = jax.lax.dynamic_slice_in_dim(brm, idx * v_loc, v_loc,
                                               axis=1)
        dyn = dyn + brm_loc[:, None, :, None, None]
        adj = dyn * alpha + base_adj[:, None, None, :, :]
        xf = _local_project(x_l, wf, bf)              # (K,N,T,V_loc,Co)
        # per-joint temporal aggregation — fully local
        return jnp.einsum("kntvc,knvtu->nuvc", xf, adj,
                          preferred_element_type=jnp.float32)

    spec_x = _x_spec(mesh, batch_sharded)
    rep = P()
    return shard_map(
        kernel, mesh=mesh,
        in_specs=(spec_x, rep, rep, rep, rep, rep, rep, rep, rep, rep, rep),
        out_specs=spec_x,
    )(x, base_adj, alpha, wf, bf, wm1, bm1, wm2, bm2, wrm, brm)
