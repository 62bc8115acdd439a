"""The port's dataset tools against the JAX package's, on the CPU: the
NumPy host tools of ``legion_tpu_torch/native.py`` against the C++ of
``legion_tpu/native`` (which this machine builds), and every subcommand of
``legion_tpu_torch/tools/prepare.py`` against ``legion_tpu/tools/
prepare.py``: the files they write are equal byte for byte."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from legion_tpu import native as jnative
from legion_tpu.tools import prepare as jprepare
from legion_tpu_torch import native
from legion_tpu_torch.tools import prepare

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _cpp():
    assert jnative._load() is not None, "the JAX package's C++ tools"


def _files(d):
    return {f: (Path(d) / f).read_bytes() for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("seed", [0, 1])
def test_edges_to_csr_matches_cpp(seed):
    """Self-loops, repeated edges and endpoints outside [0, V) (negative
    and past the end) are dropped or kept as the C++ does, and a source's
    edges keep their input order."""
    rng = np.random.default_rng(seed)
    V, E = 300, 5000
    src = rng.integers(-5, V + 5, E)
    dst = rng.integers(-5, V + 5, E)
    src[:200], dst[:200] = np.arange(200) % V, np.arange(200) % V
    src[200:400], dst[200:400] = 7, 11
    ip, ix = native.edges_to_csr(src, dst, V)
    jp, jx = jnative.edges_to_csr(src, dst, V)
    assert ip.dtype == jp.dtype == np.int64
    assert ix.dtype == jx.dtype == np.int32
    np.testing.assert_array_equal(ip, jp)
    np.testing.assert_array_equal(ix, jx)


@pytest.mark.parametrize("parts", [2, 4])
def test_partition_ldg_matches_cpp(small_dataset, parts):
    g = small_dataset.graph
    got = native.partition_ldg(g.indptr, g.indices, parts, passes=2)
    want = jnative.partition_ldg(g.indptr, g.indices, parts, passes=2)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_partition_ldg_one_pass_and_ties():
    """A graph with isolated vertices (every score 0: ties go to the
    smaller part) and one pass."""
    rng = np.random.default_rng(4)
    V = 120
    src = rng.integers(0, 60, 400)
    dst = rng.integers(0, 60, 400)
    indptr, indices = native.edges_to_csr(src, dst, V)
    for passes in (1, 3):
        np.testing.assert_array_equal(
            native.partition_ldg(indptr, indices, 3, passes),
            jnative.partition_ldg(indptr, indices, 3, passes))


_EDGELIST = (
    "100\t200\n"
    "200 100\n"
    "  5   5  \n"                 # self-loop, skipped before interning
    "-3\t900000000000\n"          # signed and sparse raw ids
    "\n"
    "900000000000 7 7 100\r\n"    # two edges on a line; CRLF
    "42\n"                        # a line that ends after the first id
    "7\t\t  -3\n"
    "100 200\n")                  # a repeated edge


def test_convert_edgelist_matches_cpp(tmp_path):
    el = tmp_path / "edges.txt"
    el.write_text(_EDGELIST)
    got = native.convert_edgelist(str(el), str(tmp_path / "p"))
    want = jnative.convert_edgelist(str(el), str(tmp_path / "j"))
    assert got == want
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    assert sorted(os.listdir(tmp_path / "p")) == ["edge_dst", "edge_src"]


def _edgelist_from(ds, path, n=5000):
    src = np.repeat(np.arange(ds.meta.num_nodes), ds.graph.degrees())
    with open(path, "w") as f:
        for i, (s, d) in enumerate(zip(src[:n], ds.graph.indices[:n])):
            f.write(f"{s}{' ' if i % 2 else chr(9)}{d}\n")


def test_prepare_pipeline_matches_jax(tmp_path, small_dataset):
    """convert, gensets, partition and synthfeat write the files JAX's
    prepare writes for the same arguments."""
    el = tmp_path / "edges.txt"
    _edgelist_from(small_dataset, el)
    outs = {}
    for name, mod in (("p", prepare), ("j", jprepare)):
        out = str(tmp_path / name)
        mod.main(["convert", "--edgelist", str(el), "--out", out])
        V = os.path.getsize(os.path.join(out, "edge_src")) // 8 - 1
        mod.main(["gensets", "--out", out, "--nodes", str(V),
                  "--train-frac", "0.2", "--valid-frac", "0.05",
                  "--seed", "3"])
        mod.main(["partition", "--out", out, "--parts", "3"])
        mod.main(["synthfeat", "--out", out, "--nodes", str(V),
                  "--feature-dim", "16", "--classes", "5", "--seed", "2"])
        outs[name] = _files(out)
    assert sorted(outs["p"]) == ["edge_dst", "edge_src", "features",
                                 "labels", "partition", "testingset",
                                 "trainingset", "validationset"]
    assert outs["p"] == outs["j"]


def test_prepare_ogb_npy_matches_jax(tmp_path):
    """``ogb --npy-dir``: the symmetrised graph (self-loops dropped),
    features, labels and splits, byte for byte; no ``ogb`` package."""
    rng = np.random.default_rng(5)
    V, E, F = 500, 4000, 12
    npy = tmp_path / "npy"
    os.makedirs(npy)
    np.save(npy / "edge_index.npy", rng.integers(0, V, (2, E),
                                                 dtype=np.int64))
    np.save(npy / "node_feat.npy",
            rng.standard_normal((V, F)).astype(np.float64))
    np.save(npy / "labels.npy", rng.integers(0, 7, (V, 1)))
    ids = rng.permutation(V)
    np.save(npy / "train_idx.npy", ids[:200])
    np.save(npy / "valid_idx.npy", ids[200:300])
    np.save(npy / "test_idx.npy", ids[300:400])
    for name, mod in (("p", prepare), ("j", jprepare)):
        mod.main(["ogb", "--out", str(tmp_path / name), "--npy-dir",
                  str(npy)])
    assert _files(tmp_path / "p") == _files(tmp_path / "j")
    assert "features" in _files(tmp_path / "p")


@pytest.mark.parametrize("module", ["legion_tpu_torch.run",
                                    "legion_tpu_torch.tools.prepare"])
def test_entry_points_help(module):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-m", module, "--help"],
                         capture_output=True, text=True, env=env, cwd=REPO,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage" in out.stdout


@pytest.mark.parametrize("seed", [0, 3])
def test_homophilous_dataset_equals_the_example(seed, tmp_path):
    """``legion_tpu_torch.data.homophilous_dataset`` against
    ``examples/ab_accuracy.py::homophilous_dataset`` at a small size: the
    meta and every array equal byte for byte, and so do the files
    ``write_legion_dataset`` makes of them in both packages."""
    import importlib.util

    from legion_tpu.data.format import write_legion_dataset as jwrite
    from legion_tpu_torch.data import homophilous_dataset, write_legion_dataset
    spec = importlib.util.spec_from_file_location(
        "ab_accuracy", REPO / "examples" / "ab_accuracy.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    args = (3000, 7, 12, 5, 64)
    ref = ab.homophilous_dataset(*args, seed=seed)
    got = homophilous_dataset(*args, seed=seed)
    assert vars(got.meta) == vars(ref.meta)
    for name in ("features", "labels", "train_ids", "valid_ids",
                 "test_ids"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for name in ("indptr", "indices"):
        a, b = getattr(got.graph, name), getattr(ref.graph, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    for ds, write, d in ((got, write_legion_dataset, "port"),
                         (ref, jwrite, "jax")):
        write(str(tmp_path / d), ds.graph, ds.features, ds.labels,
              ds.train_ids, ds.valid_ids, ds.test_ids)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
