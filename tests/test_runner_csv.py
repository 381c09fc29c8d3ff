"""Runner metric CSVs keep the format the pandas writer produced."""

import numpy as np
import pytest

from dstdgcn_tpu.runner.base import write_csv


def test_csv_matches_pandas_era_format(tmp_path):
    pd = pytest.importorskip("pandas")
    head = ["epoch", "lr", "train_loss", "test_loss", "3d80"]
    rows = [np.array([1.0, 0.003, 12.345678901234, 101.5, np.nan]),
            np.array([2.0, 0.0027, 1e-12, 3.0, 7.25])]
    best = np.array([2.0, 0.0027, 1e-12, 3.0, 7.25])
    mixed = [["walking", 12.5, np.float64(0.1), np.float64(1e20)],
             ["average", 12.5, np.float64(0.1), np.float64(2.0)]]

    ours = tmp_path / "ours.csv"
    write_csv(str(ours), rows[:1], head)
    write_csv(str(ours), rows[1:], append=True)
    write_csv(str(ours), [best], append=True)
    ours_mixed = tmp_path / "ours_mixed.csv"
    write_csv(str(ours_mixed), mixed, ["action", "avg", "40", "80"])

    ref = tmp_path / "ref.csv"
    pd.DataFrame(np.expand_dims(rows[0], 0)).to_csv(ref, header=head,
                                                    index=False)
    for r in (rows[1], best):
        with open(ref, "a") as f:
            pd.DataFrame(np.expand_dims(r, 0)).to_csv(f, header=False,
                                                      index=False)
    ref_mixed = tmp_path / "ref_mixed.csv"
    pd.DataFrame(mixed).to_csv(ref_mixed, header=["action", "avg", "40",
                                                  "80"], index=False)
    assert ours.read_text() == ref.read_text()
    assert ours_mixed.read_text() == ref_mixed.read_text()
