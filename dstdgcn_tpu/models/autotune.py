"""Measured per-shape performance-knob selection ("auto" knobs).

``bench.py --autotune`` times three settings interleaved on the card —
float32 (TF32 dots at default precision), bfloat16 compute, and bfloat16
with (5, 2) block-diagonal grouped aggregation — for the flagship H36M
train step and eval forward.  Medians on one NVIDIA H100 80GB HBM3 at a
400 W power limit, two sweeps (7 and 15 rounds; full rows in CHANGES.md):

  ==============  =========  =========  ===========  =========
  cell            f32 ms     bf16 ms    bf16+(5,2)   winner
  ==============  =========  =========  ===========  =========
  train b32       9.742      10.202     11.702       f32
  train b32       9.942      9.880      10.366       (tie)
  train b64       13.093     11.777     14.287       bf16
  train b128      21.706     17.485     25.289       bf16
  eval b1         0.302      0.273      0.285        (tie)
  eval b1         0.375      0.348      0.328        (tie)
  eval b512       9.134      5.972      7.869        bf16
  ==============  =========  =========  ===========  =========

The block-diagonal grouping (built to widen tiny per-item matrix
products) never wins a cell outside the run-to-run spread, so "auto"
never groups.  bf16 wins from batch 64 up.  Below 64 no setting wins
twice (the gaps lie inside each setting's spread), so the small batches
keep float32, the more precise setting.

The resolution is static per compiled shape: batch size is a trace-time
constant under ``jit``, so each batch size compiles with its own knobs and
no runtime dispatch exists.  A config sets ``compute_dtype: auto`` (and
friends) to follow this table; explicit values pass through untouched.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

#: knobs that accept the string "auto" in DSTDGCN / config files
AUTO_KNOBS = ("compute_dtype", "agg_group_spatial", "agg_group_temporal")


def resolve_auto(batch_size: int) -> Dict[str, Any]:
    """The H100 winners for a given batch size (table above)."""
    return dict(compute_dtype=None if batch_size < 64 else "bfloat16",
                agg_group_spatial=None, agg_group_temporal=None)


def per_chip_batch(batch_size: int) -> int:
    """Per-device batch: the measured winners are PER-DEVICE shapes, but
    a traced ``x.shape[0]`` under GSPMD is the GLOBAL batch — divide by
    the active mesh's data-axis size so e.g. global 256 over data=8
    resolves as the batch-32 regime it actually computes per device."""
    from ..parallel.mesh import _ACTIVE_MESH
    mesh = _ACTIVE_MESH.get()
    if mesh is None:
        return batch_size
    return max(1, batch_size // mesh.shape.get("data", 1))


def resolve_knob(name: str, value: Union[str, int, None],
                 batch_size: int,
                 batch_hint: Optional[int] = None) -> Optional[Any]:
    """Return ``value`` unless it is the string "auto".

    ``batch_hint`` (the configured batch size, plumbed by the runner as
    ``auto_batch_hint``) overrides the traced shape so (a) a ragged final
    batch does not flip the knobs mid-run — one step per epoch silently
    trading bf16 for f32 AND paying a fresh compile — and (b) all
    shapes of a run share one knob set.  The hint is the PER-PROCESS
    loader batch, while the traced shape and the mesh data axis are
    global — multiply by process_count so both inputs reach
    :func:`per_chip_batch` in global terms.
    """
    if value == "auto":
        if batch_hint is not None:
            import jax
            batch_hint = batch_hint * jax.process_count()
        return resolve_auto(per_chip_batch(batch_hint or batch_size))[name]
    return value
