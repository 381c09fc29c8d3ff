"""CPU guards for the benchmark harness (bench.py at the repo root).

The GPU timings cannot run here; what CAN be locked is that the
bench-local candidate formulations compute the shipped model's op — the
tether the headline number depends on — and the harness's bookkeeping."""

import numpy as np
import pytest

bench = pytest.importorskip("bench")
jnp = pytest.importorskip("jax.numpy")


def test_tether_candidate_matches_module_path():
    rng = np.random.RandomState(0)
    params = bench._naive_params(rng, 2, 8, 10, 6)
    x = jnp.asarray(rng.randn(4, 10, 6, 8).astype(np.float32))
    # full-chain tether, per dtype (VERDICT r4 next #6b)
    assert bench.tether_check(params, x, "float32") < 1e-4
    assert bench.tether_check(params, x, "bfloat16") < 2e-2


def test_print_result_fits_driver_window(tmp_path, monkeypatch, capsys):
    """The compact line carries the headline keys within its budget and
    references the full record, which keeps the verbose sections."""
    import json

    monkeypatch.setattr(bench, "_FULL_RECORD",
                        str(tmp_path / "out" / "bench.json"))
    r = dict(bench.RESULT)
    r["value"], r["vs_baseline"] = 1e9, 1.5
    r["detail"] = {k: 123.456 for k in bench._COMPACT_PRIORITY}
    r["detail"]["shapes"] = [
        {"shape": f"s{i}", "speedup": 1.1, "auto_matches_winner": True,
         "padding": "x" * 400} for i in range(6)]
    bench._print_result(r)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(line) < 2000
    d = json.loads(line)
    for key in ("metric", "value", "vs_baseline", "full_record"):
        assert key in d
    for key in ("step_ms_ours", "train_step_ms_b128", "pct_of_bf16_peak",
                "tether_ok"):
        assert key in d["detail"], key
    assert d["detail"]["auto_matches_winner_all"] is True
    full = json.loads((tmp_path / "out" / "bench.json").read_text())
    assert len(full["detail"]["shapes"]) == 6


def test_device_peaks_table():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks == dict(bf16_flops=989e12, hbm_bytes_per_s=3.35e12)
    with pytest.raises(ValueError, match="no published peaks"):
        bench.device_peaks("Unlisted GPU")


def test_device_record_refuses_cpu():
    with pytest.raises(RuntimeError, match="measures a GPU"):
        bench.device_record()


def test_median_ms_blocks_and_counts_calls():
    calls = []

    def fn(x):
        calls.append(1)
        return jnp.asarray(x) * 2

    ms = bench.median_ms(fn, 3.0, runs=5, warmup=2, inner=3)
    assert ms >= 0 and len(calls) == 2 + 5 * 3


def test_auto_kwargs_follow_policy():
    from dstdgcn_tpu.models.autotune import resolve_auto

    for n in (1, 32, 128, 512, 2048):
        kw = bench._auto_kwargs(n)
        pol = resolve_auto(n)
        assert kw["agg_group_s"] == pol["agg_group_spatial"]
        assert (kw["dtype"] is None) == (pol["compute_dtype"] is None)


def test_naive_reference_matches_stacked():
    """The reference-style baseline and our stacked formulation are the
    same function (different layouts): vs_baseline measures formulation
    speed, not different math."""
    rng = np.random.RandomState(1)
    params = bench._naive_params(rng, 2, 8, 10, 6)
    x = jnp.asarray(rng.randn(4, 10, 6, 8).astype(np.float32))
    x_nctv = jnp.transpose(x, (0, 3, 1, 2))
    want = np.asarray(bench.naive_reference_forward(params, x_nctv))
    got = np.asarray(bench.stacked_forward(params, x))
    got_nctv = np.transpose(got, (0, 3, 1, 2))
    err = np.abs(got_nctv - want).max() / max(np.abs(want).max(), 1.0)
    assert err < 1e-4
