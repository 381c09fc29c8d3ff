"""Ring-collective overlap verification.

Two layers of evidence that ``dstd_spatial_ring``'s communication can
overlap compute:

1. **Dataflow independence** (compiled fresh on the CPU mesh every run):
   no ``ppermute`` send depends on any round's score/mixing/aggregation
   compute — the property that *permits* the scheduler to hide the
   transfer.  If a refactor made round r+1's send consume round r's
   output, this fails on any backend.
2. **Scheduled overlap** (``hlo_check.check_overlap``): on a scheduled
   module the async ``collective-permute-start``/``-done`` pairs must
   bracket matmuls.  The CPU backend emits synchronous permutes, so the
   parser is checked here on a small GPU-style schedule;
   ``chip_smoke.py --four-cards`` runs it on the ring's real GPU schedule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dstdgcn_tpu.parallel import hlo_check, make_mesh
from dstdgcn_tpu.parallel.shard import dstd_spatial_ring


def _ring_args(rng, v=16, t=6, c=8, k=2):
    mk = lambda *s: jnp.asarray(rng.randn(*s), jnp.float32)  # noqa: E731
    return (mk(2, t, v, c), mk(k, v, v), jnp.asarray(0.5), mk(k, c, c),
            mk(k, c), mk(k, c, 2), mk(k, 2), mk(k, c, 2), mk(k, 2),
            mk(k, 2, t, t), mk(k, t))


def test_ring_sends_independent_of_round_compute():
    mesh = make_mesh(data=2, graph=4)
    rng = np.random.RandomState(0)
    args = _ring_args(rng)
    txt = jax.jit(
        lambda *a: dstd_spatial_ring(mesh, *a)).lower(*args).compile() \
        .as_text()
    res = hlo_check.check_send_independence(txt)
    nshard = mesh.shape["graph"]
    # one q-chunk + one xf-chunk permute per non-final round
    assert res["num_permutes"] == 2 * (nshard - 1)
    assert res["violations"] == []


_SCHEDULED = """HloModule ring, is_scheduled=true

%fused_dot (p0: f32[4,4], p1: f32[4,4]) -> f32[4,4] {
  %p0 = f32[4,4]{1,0} parameter(0)
  %p1 = f32[4,4]{1,0} parameter(1)
  ROOT %d = f32[4,4]{1,0} dot(%p0, %p1), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

ENTRY %main (a: f32[4,4], b: f32[4,4]) -> f32[4,4] {
  %a = f32[4,4]{1,0} parameter(0)
  %b = f32[4,4]{1,0} parameter(1)
  %cp-start = (f32[4,4]{1,0}, f32[4,4]{1,0}) collective-permute-start(%a), source_target_pairs={{0,1},{1,0}}
  %gemm = f32[4,4]{1,0} custom-call(%a, %b), custom_call_target="__cublas$gemm"
  %cp-done = f32[4,4]{1,0} collective-permute-done(%cp-start)
  %cp-start.1 = (f32[4,4]{1,0}, f32[4,4]{1,0}) collective-permute-start(%cp-done), source_target_pairs={{0,1},{1,0}}
  %cp-done.1 = f32[4,4]{1,0} collective-permute-done(%cp-start.1)
  %fusion = f32[4,4]{1,0} fusion(%cp-done.1, %gemm), kind=kCustom, calls=%fused_dot
  ROOT %out = f32[4,4]{1,0} add(%fusion, %b)
}
"""


def test_check_overlap_reads_a_gpu_schedule():
    ov = hlo_check.check_overlap(_SCHEDULED)
    assert ov["num_pairs"] == 2
    assert ov["num_overlapped"] == 1
    assert ov["pairs"][0]["compute_between"] == ["gemm"]
    assert ov["pairs"][1]["compute_between"] == []


def test_check_overlap_rejects_unscheduled_hlo():
    with pytest.raises(AssertionError, match="not scheduled"):
        hlo_check.check_overlap(_SCHEDULED.replace("is_scheduled=true",
                                                   ""))
