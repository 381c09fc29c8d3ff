"""REAL multi-process launch test (jax.distributed over 2 CPU processes).

Until round 5 the multi-host path was validated only as a single-process
no-op plus virtual-mesh sharding tests; an actual 2-process launch then
exposed a real bug (``jax.device_put`` rejects non-addressable shardings,
so ``engine.init`` crashed placing the model state — fixed by
``parallel.mesh.place_tree``).  This test keeps the whole hot path honest
end to end: ``jax.distributed.initialize`` via ``parallel.distributed``,
a data mesh spanning both processes (4 virtual CPU devices each), state
placement, global-batch assembly, the compiled train step with gloo
collectives — and asserts the loss matches a single-process run of the
identical global batch to f32 noise.  The worker also runs the
ring-pipelined spatial op with the graph axis SPANNING the two
processes (``ppermute`` over gloo, the north-star edge-partitioned
config) and golden-checks its addressable shards against the local
oracle.
"""

import json
import os
import socket
import subprocess
import sys

_WORKER = r'''
import os, sys, json
sys.path.insert(0, os.environ["REPO"])
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
try:
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
except Exception:
    pass
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

single = os.environ.get("MH_SINGLE") == "1"
if not single:
    from dstdgcn_tpu.parallel import distributed as dist
    pid, nproc = dist.initialize()
else:
    pid, nproc = 0, 1

from dstdgcn_tpu.engine import PredictionEngine
from dstdgcn_tpu.models import DSTDGCN
from dstdgcn_tpu.parallel import activation_sharding_context, make_mesh

mesh = make_mesh(data=jax.device_count())
model = DSTDGCN(input_channels=6, input_time_frame=10, output_time_frame=5,
                st_gcnn_dropout=0.0, joints_to_consider=22, num_feature=16,
                num_layers=1, layout="h36m")
cfg = dict(learn=dict(opt="adam", lr=1e-3, weight_decay=0, gamma=0.9,
                      step_size=5),
           loss=dict(joint=["jl2", 1]), n_out=1, transform="tsc",
           use_weight=False, inverse=True, max_iter=-1)
eng = PredictionEngine(cfg, model)
eng.mesh = mesh
eng.data_sharding = NamedSharding(mesh, P("data"))

g = np.random.RandomState(7)
g_inputs = g.randn(16, 15, 66).astype(np.float32)
g_targets = g.randn(16, 15, 66).astype(np.float32)
g_inv = g_inputs[:, ::-1].copy()
per = 16 // nproc
lo = pid * per
inputs, inv, targets = (a if single else a[lo:lo + per]
                        for a in (g_inputs, g_inv, g_targets))

eng.init(g_inputs[:1], seed=0)
step = eng._build_train_step(None, None, None)
with activation_sharding_context(mesh):
    batch = eng._put_batch(inputs, inv, targets)
    state, losses = step(eng.state, *batch, jnp.asarray(1e-3, jnp.float32))
    jax.block_until_ready(losses)
# north-star path across REAL process boundaries: the ring-pipelined
# spatial op with the graph axis spanning both processes (ppermute over
# gloo), golden-checked against the local oracle
from dstdgcn_tpu.ops import dstd as xops
from dstdgcn_tpu.parallel import dstd_spatial_ring

rmesh = make_mesh(data=2, graph=jax.device_count() // 2)
rg = np.random.RandomState(3)
v_ring = rmesh.shape["graph"] * 4
xr = jnp.asarray(rg.randn(2, 6, v_ring, 8), jnp.float32)
base = jnp.asarray(rg.randn(2, v_ring, v_ring), jnp.float32) * 0.3
wk = {k: jnp.asarray(rg.randn(*shp), jnp.float32) * 0.2 for k, shp in
      dict(wf=(2, 8, 8), bf=(2, 8), wm1=(2, 8, 2), bm1=(2, 2),
           wm2=(2, 8, 2), bm2=(2, 2), wrm=(2, 2, 6, 6),
           brm=(2, 6)).items()}
ring_args = (xr, base, jnp.asarray(0.5), wk["wf"], wk["bf"], wk["wm1"],
             wk["bm1"], wk["wm2"], wk["bm2"], wk["wrm"], wk["brm"])
ring = dstd_spatial_ring(rmesh, *ring_args)
want = xops.dstd_spatial(*ring_args)
# compare only this process's addressable joint slices
err = 0.0
for sh in ring.addressable_shards:
    got = np.asarray(sh.data)
    ref = np.asarray(want)[sh.index]
    err = max(err, float(np.abs(got - ref).max() /
                         max(np.abs(ref).max(), 1e-6)))
assert err < 1e-5, f"ring mismatch across processes: {err}"

if pid == 0:
    print("RESULT " + json.dumps(
        {**{k: float(v) for k, v in losses.items()},
         "ring_rel_err": err}), flush=True)
'''


def _run(env, tmp_path, name):
    path = tmp_path / "worker.py"
    path.write_text(_WORKER)
    repo = os.path.join(os.path.dirname(__file__), "..")
    full = {**os.environ, **env, "REPO": repo}
    # the worker picks its own platform (CPU) before importing jax
    full.pop("JAX_PLATFORMS", None)
    return subprocess.Popen([sys.executable, str(path)], env=full,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _result(out):
    for line in out.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise AssertionError(f"no RESULT line in:\n{out[-2000:]}")


def test_two_process_train_step_matches_single(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    p_single = _run({"MH_SINGLE": "1"}, tmp_path, "single")
    out_s, _ = p_single.communicate(timeout=420)
    assert p_single.returncode == 0, out_s[-2000:]
    want = _result(out_s)

    procs = [_run({"DSTDGCN_COORDINATOR": f"localhost:{port}",
                   "DSTDGCN_NUM_PROCESSES": "2",
                   "DSTDGCN_PROCESS_ID": str(i)}, tmp_path, f"p{i}")
             for i in range(2)]
    outs = [p.communicate(timeout=420)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
    got = _result(outs[0])

    # the ring golden check is absolute (vs the local oracle), not a
    # cross-run quantity — both runs must simply pass it
    assert want.pop("ring_rel_err") < 1e-5
    assert got.pop("ring_rel_err") < 1e-5
    for k, v in want.items():
        rel = abs(got[k] - v) / max(abs(v), 1e-9)
        assert rel < 1e-5, (k, want, got)
