"""File-loader tests: synthetic expmap/pickle files through the full
dataset construction path, including parity with the reference loaders
(reference run on CPU via a cuda-noop monkeypatch)."""

import os
import pickle
import sys

import numpy as np
import pytest

from dstdgcn_tpu.data import datasets

REF = "/root/reference"
if REF not in sys.path:
    sys.path.insert(0, REF)


def _ref_utils():
    """The reference's ``dataset.utils``, or a skip when the reference
    checkout is absent (reference parity is then held by the in-repo
    oracles only)."""
    try:
        from dataset import utils
    except Exception:
        pytest.skip("reference not available")
    return utils


def _write_h36m_tree(root, rng, n_frames=240):
    """Minimal S1/S5 expmap CSV tree (99 channels)."""
    for subj in (1, 5):
        d = os.path.join(root, f"S{subj}")
        os.makedirs(d, exist_ok=True)
        for act in ("walking",):
            for sub in (1, 2):
                arr = 0.3 * rng.randn(n_frames, 99).astype(np.float32)
                np.savetxt(os.path.join(d, f"{act}_{sub}.txt"), arr,
                           delimiter=",", fmt="%.6f")


def test_h36m_loader_train_windows(tmp_path, rng):
    _write_h36m_tree(tmp_path, rng)
    ds = datasets.Human36M(str(tmp_path), actions="walking", input_n=10,
                           output_n=5, dct_used=0, mode="debug",
                           sample_rate=2, mirror=True)
    # 240 frames -> 120 sampled; windows = 120-15+1 = 106 per subaction,
    # x2 subactions, x2 mirror
    assert len(ds) == 106 * 2 * 2
    assert ds.all_seqs.shape[1:] == (15, 96)
    assert ds.input_seqs.shape[2] == 66


def test_h36m_loader_matches_reference_cpu(tmp_path, rng):
    torch = pytest.importorskip("torch")
    _write_h36m_tree(tmp_path, rng)
    # route the reference's hard .cuda() calls to CPU
    orig = torch.Tensor.cuda
    torch.Tensor.cuda = lambda self, *a, **k: self
    try:
        load_data_3d = _ref_utils().load_data_3d
        ref_seqs, ref_ign, ref_used = load_data_3d(
            str(tmp_path), [1], ["walking"], 2, 15, "all")
    finally:
        torch.Tensor.cuda = orig
    ours, ign, used = datasets.load_h36m_3d(
        str(tmp_path), [1], ["walking"], 2, 15, "all")
    np.testing.assert_array_equal(used, ref_used)
    assert ours.shape == ref_seqs.shape
    np.testing.assert_allclose(ours, ref_seqs, rtol=1e-4, atol=1e-2)


def test_h36m_test_split_srnn_windows(tmp_path, rng):
    _write_h36m_tree(tmp_path, rng, n_frames=800)
    ds = datasets.Human36M(str(tmp_path), actions="walking", input_n=10,
                           output_n=5, dct_used=0, mode="test",
                           sample_rate=2, test_mode="8")
    assert len(ds) == 8  # 4 windows from each subaction


def test_cmu_loader(tmp_path, rng):
    d = os.path.join(tmp_path, "walking")
    os.makedirs(d)
    for i in (1, 2):
        arr = 0.3 * rng.randn(100, 117).astype(np.float32)
        np.savetxt(os.path.join(d, f"walking_{i}.txt"), arr, delimiter=",",
                   fmt="%.6f")
    ds = datasets.CMUMocap(str(tmp_path), actions="walking", input_n=10,
                           output_n=5, dct_used=0, sample_rate=2,
                           test_mode="all")
    assert ds.all_seqs.shape[1:] == (15, 114)
    assert ds.input_seqs.shape[2] == 75


def test_pw3d_loader(tmp_path, rng):
    blob = {"jointPositions": [rng.randn(60, 72).astype(np.float64)]}
    with open(os.path.join(tmp_path, "seq.pkl"), "wb") as f:
        pickle.dump(blob, f)
    ds = datasets.PW3D(str(tmp_path) + "/", input_n=10, output_n=5,
                       dct_used=0)
    assert ds.all_seqs.shape == (46, 15, 72)
    assert ds.input_seqs.shape[2] == 69
    # root-centred: joint 0 is at the origin
    np.testing.assert_allclose(ds.all_seqs[:, :, :3], 0, atol=1e-5)


def test_h36m_angle_loader_train_matches_reference(tmp_path, rng):
    """Golden vs reference ``load_data`` (utils.py:728-822) on the train
    path.  The reference's own call site crashes (3-of-5 unpack,
    dataset/h36m.py:44); calling the loader directly is well-defined."""
    pytest.importorskip("torch")
    _write_h36m_tree(tmp_path, rng)
    load_data = _ref_utils().load_data
    ref_seqs, ref_ign, ref_used, ref_mean, ref_std = load_data(
        str(tmp_path), [1], ["walking"], 2, 15, input_n=10)
    ours, ign, used, mean, std = datasets.load_h36m_angles(
        str(tmp_path), [1], ["walking"], 2, 15, input_n=10)
    np.testing.assert_array_equal(used, ref_used)
    np.testing.assert_array_equal(ign, ref_ign)
    np.testing.assert_allclose(ours, ref_seqs, atol=1e-5)
    np.testing.assert_allclose(mean, ref_mean, atol=1e-5)
    np.testing.assert_allclose(std, ref_std, atol=1e-5)


def test_h36m_angle_loader_srnn_matches_reference(tmp_path, rng):
    pytest.importorskip("torch")
    _write_h36m_tree(tmp_path, rng, n_frames=800)
    load_data = _ref_utils().load_data
    ref_seqs, _, ref_used, _, _ = load_data(
        str(tmp_path), [5], ["walking"], 2, 15, input_n=10)
    ours, _, used, _, _ = datasets.load_h36m_angles(
        str(tmp_path), [5], ["walking"], 2, 15, input_n=10, test_mode="8")
    np.testing.assert_array_equal(used, ref_used)
    np.testing.assert_allclose(ours, ref_seqs, atol=1e-5)


def test_h36m_dataset_angle_space(tmp_path, rng):
    _write_h36m_tree(tmp_path, rng)
    ds = datasets.Human36M(str(tmp_path), actions="walking", input_n=10,
                           output_n=5, dct_used=0, mode="debug",
                           sample_rate=2, data_3d=False)
    # raw expmap channels: 99 wide, no mirror augmentation
    assert ds.all_seqs.shape[1:] == (15, 99)
    assert len(ds) == 106 * 2
    assert ds.input_seqs.shape[2] == len(ds.dim_used)
    assert ds.angle_std.shape == (99,)


def test_cmu_angle_loader_matches_reference(tmp_path, rng):
    pytest.importorskip("torch")
    d = os.path.join(tmp_path, "walking")
    os.makedirs(d)
    for i in (1, 2):
        arr = 0.3 * rng.randn(200, 117).astype(np.float32)
        np.savetxt(os.path.join(d, f"walking_{i}.txt"), arr, delimiter=",",
                   fmt="%.6f")
    load_data_cmu = _ref_utils().load_data_cmu
    ref_seqs, ref_ign, ref_used, ref_mean, ref_std = load_data_cmu(
        str(tmp_path), ["walking"], 10, 5)
    ours, ign, used, mean, std = datasets.load_cmu_angles(
        str(tmp_path), ["walking"], 10, 5)
    np.testing.assert_array_equal(used, ref_used)
    np.testing.assert_allclose(ours, ref_seqs, atol=1e-5)
    np.testing.assert_allclose(std, ref_std, atol=1e-5)
    # test split reuses the train stats (utils.py:513-523)
    ref_t, _, ref_used_t, _, _ = load_data_cmu(
        str(tmp_path), ["walking"], 10, 5, data_std=ref_std.copy(),
        data_mean=ref_mean.copy(), is_test=True)
    ours_t, _, used_t, _, _ = datasets.load_cmu_angles(
        str(tmp_path), ["walking"], 10, 5, data_std=std, data_mean=mean,
        is_test=True)
    np.testing.assert_array_equal(used_t, ref_used_t)
    np.testing.assert_allclose(ours_t, ref_t, atol=1e-5)
    ds = datasets.CMUMocap(str(tmp_path), actions="walking", input_n=10,
                           output_n=5, dct_used=0, data_3d=False,
                           test_mode="all")
    assert ds.all_seqs.shape[1:] == (15, 117)


def test_native_csv_reader_matches_numpy(tmp_path, rng):
    arr = rng.randn(40, 13).astype(np.float32)
    path = os.path.join(tmp_path, "x.txt")
    np.savetxt(path, arr, delimiter=",", fmt="%.6f")
    got = datasets.read_csv_floats(path)
    np.testing.assert_allclose(got, arr, atol=1e-5)
    from dstdgcn_tpu.data.native import fast_read_csv
    native = fast_read_csv(path)
    if native is not None:  # toolchain present
        np.testing.assert_allclose(native, arr, atol=1e-5)
