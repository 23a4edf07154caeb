"""Port datasets and metrics against ``ggad_tpu``: the same seed gives
bit-identical arrays; metrics agree to 1e-12 (both are float64 numpy)."""

import numpy as np
import pytest

import ggad_tpu.datasets.loaders as jax_loaders
import ggad_tpu.datasets.splits as jax_splits
import ggad_tpu.datasets.synthetic as jax_synth
import ggad_tpu.ops.metrics as jax_metrics
import ggad_tpu_torch.datasets.loaders as pt_loaders
import ggad_tpu_torch.datasets.splits as pt_splits
import ggad_tpu_torch.datasets.synthetic as pt_synth
import ggad_tpu_torch.ops.metrics as pt_metrics

FIELDS = ("features", "ano_labels", "idx_train", "idx_val", "idx_test",
          "normal_label_idx", "abnormal_label_idx")


def assert_same_dataset(a, b):
    assert a.name == b.name
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    assert (a.adj != b.adj).nnz == 0
    np.testing.assert_array_equal(a.adj.indptr, b.adj.indptr)
    np.testing.assert_array_equal(a.adj.indices, b.adj.indices)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_synthetic_gad_bit_identical(seed):
    kw = dict(n_nodes=300, avg_degree=6, feat_dim=16, n_communities=4,
              anomaly_rate=0.1, seed=seed, split_seed=seed + 1)
    assert_same_dataset(pt_synth.synthetic_gad(**kw),
                        jax_synth.synthetic_gad(**kw))


@pytest.mark.parametrize("name,seed", [("photo", 0), ("photo", 3),
                                       ("Amazon", 1), ("elliptic", 2)])
def test_synthetic_like_bit_identical(name, seed):
    assert_same_dataset(pt_synth.synthetic_like(name, scale=0.02, seed=seed),
                        jax_synth.synthetic_like(name, scale=0.02, seed=seed))


@pytest.mark.parametrize("seed,seed_frac", [(0, 0.15), (5, 0.15),
                                            (2, 0.05)])
def test_reference_split_bit_identical(seed, seed_frac):
    labels = (np.random.default_rng(seed).random(500) < 0.1).astype(np.int64)
    kw = dict(seed=seed, seed_frac=seed_frac)
    a = pt_splits.reference_split(labels, **kw)
    b = jax_splits.reference_split(labels, **kw)
    for f in ("idx_train", "idx_val", "idx_test", "normal_label_idx",
              "abnormal_label_idx"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_photo_bench_is_the_benchmark_graph():
    """The port's photo-shaped serving graph is bench.py:45-49's."""
    a = pt_synth.photo_bench()
    b = jax_synth.synthetic_gad(
        name="bench_photo", n_nodes=7535, avg_degree=31, feat_dim=745,
        n_communities=8, anomaly_rate=0.09, seed=0, seed_frac=0.15)
    assert_same_dataset(a, b)
    assert (a.n_nodes, a.n_edges, a.feat_dim) == (7535, 456524, 745)


@pytest.mark.parametrize("name", ["photo", "synthetic"])
def test_load_dataset_fallback_matches(name, tmp_path, capsys):
    kw = dict(data_dir=str(tmp_path), seed=1, synthetic_scale=0.03)
    a = pt_loaders.load_dataset(name, **kw)
    b = jax_loaders.load_dataset(name, **kw)
    assert_same_dataset(a, b)
    if name == "photo":
        assert "[synthetic fallback]" in capsys.readouterr().err
        with pytest.raises(FileNotFoundError):
            pt_loaders.load_dataset(name, allow_synthetic=False, **kw)


def test_load_mat_matches(tmp_path):
    import scipy.io as sio
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    n = 80
    a = sp.random(n, n, density=0.1, random_state=1, format="csr")
    a = ((a + a.T) > 0).astype(np.float64)
    sio.savemat(tmp_path / "Amazon.mat", {
        "Network": a, "Attributes": rng.random((n, 5)),
        "Label": (rng.random(n) < 0.1).astype(np.int64)[:, None]})
    assert_same_dataset(
        pt_loaders.load_dataset("Amazon", data_dir=str(tmp_path)),
        jax_loaders.load_dataset("Amazon", data_dir=str(tmp_path)))


@pytest.mark.parametrize("ties", [False, True])
def test_metrics_match(ties):
    rng = np.random.default_rng(3)
    labels = (rng.random(400) < 0.2).astype(np.int64)
    scores = (rng.integers(0, 6, 400).astype(float) if ties
              else rng.normal(size=400) + labels)
    assert pt_metrics.roc_auc(labels, scores) == pytest.approx(
        jax_metrics.roc_auc(labels, scores), abs=1e-12)
    assert pt_metrics.average_precision(labels, scores) == pytest.approx(
        jax_metrics.average_precision(labels, scores), abs=1e-12)
