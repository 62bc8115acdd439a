"""The host feature table that K4 and K13 read a miss from, on the CPU:
bf16 rows for a bf16 cache, as the JAX package ships a miss
(``legion_tpu/cache/unified_cache.py::CachedFeatureSource._host_gather``,
``legion_tpu/native/__init__.py::gather_rows``). The table's bits against
JAX's host gather at the values where roundings part; its pitch; the
wrappers' refusals; and which table a trainer builds, with its set-up
accounting."""

import numpy as np
import pytest
import torch

from legion_tpu import native as jax_native
from legion_tpu_torch.cache.collective import (CliqueFeatureCache,
                                               clique_gather)
from legion_tpu_torch.cache.unified_cache import (CachedFeatureSource,
                                                  UnifiedCache,
                                                  cached_gather)
from legion_tpu_torch.config import (CacheConfig, LegionConfig, MeshConfig,
                                     SamplerConfig, TrainConfig)
from legion_tpu_torch.data import synthesize_dataset
from legion_tpu_torch.ops.host_memory import (BF16_BITS, HostTable,
                                              bf16_pitch, bf16_rows)
from legion_tpu_torch.train import Trainer

# f32 bit patterns where a rounding to bf16 can part: ties to even (down
# and up), values just off a tie, subnormals, both zeros, both
# infinities, the largest finite values (which round to inf), NaNs with
# their payload in the high bits, in the low bits only (which the
# formula may carry to inf) and in both, and NaNs that it wraps to zero
SPECIAL_BITS = np.array([
    0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001, 0xBF818000,
    0x00000001, 0x00008000, 0x00018000, 0x007FFFFF, 0x80000001, 0x807F8000,
    0x00000000, 0x80000000,
    0x7F800000, 0xFF800000,
    0x7F7FFFFF, 0xFF7FFFFF, 0x7F7F7FFF,
    0x7FC00000, 0xFFC00000, 0x7F800001, 0x7F807FFF, 0xFF800001,
    0xFFFFFFFF, 0x7FFFFFFF, 0x7F80FFFF,
], dtype=np.uint32)


def _formula(bits):
    """lg_gather_rows_bf16's rounding, in Python integers mod 2^32."""
    return np.array([((int(b) + 0x7FFF + ((int(b) >> 16) & 1))
                      & 0xFFFFFFFF) >> 16 for b in bits.ravel()],
                    np.uint16).reshape(bits.shape)


@pytest.fixture(scope="module")
def special_features():
    """[40, 7] f32: the special bit patterns, then seeded normal values."""
    rng = np.random.default_rng(14)
    bits = rng.standard_normal(40 * 7).astype(np.float32).view(np.uint32)
    bits[:SPECIAL_BITS.size] = SPECIAL_BITS
    return bits.reshape(40, 7).view(np.float32)


def test_bf16_table_equals_jax_host_gather(special_features, record_property):
    """``bf16_rows`` equals JAX's ``native.gather_rows(..., dtype=
    "bfloat16")`` bit for bit on every special value and on ids with pads
    and repeats. Where JAX's C++ library is not built, its NumPy branch
    (an ml_dtypes cast) is held on the finite values and the C++ formula
    on the rest; the reference that ran is recorded as a property. The
    cast (what the cache fill uses) agrees everywhere but on NaNs."""
    f = special_features
    ids = np.array([0, 1, 2, 3, -1, 39, 3, 0, 17, -1, 5], np.int32)
    table = bf16_rows(f, f.shape[1])
    got = np.where(ids[:, None] >= 0, table[ids.clip(0)], 0)
    ref = jax_native.gather_rows(f, ids, dtype="bfloat16").view(np.uint16)
    if jax_native.available():
        record_property("reference", "C++ lg_gather_rows_bf16")
        np.testing.assert_array_equal(got, ref)
    else:
        record_property("reference", "NumPy branch on finite values, the "
                                     "C++ formula on the rest")
        finite = np.isfinite(f[ids.clip(0)]) | (ids[:, None] < 0)
        np.testing.assert_array_equal(got[finite], ref[finite])
    np.testing.assert_array_equal(table, _formula(f.view(np.uint32)))
    cast = torch.from_numpy(f).to(torch.bfloat16).view(torch.int16).numpy() \
        .view(np.uint16)
    nan = np.isnan(f)
    np.testing.assert_array_equal(table[~nan], cast[~nan])
    # NaN by the cast, but inf by the formula where the payload lies in
    # the low 16 bits and does not round up past them, and zero where the
    # sum passes 2^32
    bits = f.view(np.uint32)
    low = nan & ((bits & 0x007FFFFF) <= 0x8000)
    wrap = bits >= 0xFFFF8000
    as_f32 = (table.astype(np.uint32) << 16).view(np.float32)
    assert low.sum() == 3 and np.isinf(as_f32[low]).all()
    assert wrap.sum() == 1 and (table[wrap] == 0).all()
    assert np.isnan((cast[low | wrap].astype(np.uint32) << 16)
                    .view(np.float32)).all()
    assert (table[bits == 0x7F7FFFFF] == 0x7F80).all()


@pytest.mark.parametrize("F,P", [(100, 128), (128, 128), (602, 640),
                                 (50, 64), (32, 64), (1, 1), (24, 24),
                                 (31, 31)])
def test_bf16_pitch_pads_to_lines_within_the_f32_row(F, P):
    """The pitch pads a row to whole 128-byte lines (64 bf16 values)
    unless the padded row would be longer than the f32 row."""
    assert bf16_pitch(F) == P
    assert P >= F and 2 * P <= 4 * F
    assert P == F or (2 * P) % 128 == 0


def test_bf16_rows_by_chunks_from_a_memmap(special_features, tmp_path):
    """Any chunk size gives the same table, a read-only memmap gives the
    table of its values, the pad columns are zero, and a pitch under the
    width is refused."""
    f = np.concatenate([special_features] * 5)           # [200, 7]
    path = tmp_path / "feats"
    f.tofile(path)
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=f.shape)
    whole = bf16_rows(f, 64)
    assert whole.dtype == BF16_BITS and whole.shape == (200, 64)
    for chunk in (1, 7, 64, 1000):
        np.testing.assert_array_equal(bf16_rows(mm, 64, chunk=chunk), whole)
    np.testing.assert_array_equal(whole[:, :7], _formula(f.view(np.uint32)))
    assert not whole[:, 7:].any()
    with pytest.raises(ValueError, match="pitch"):
        bf16_rows(f, 6)


def test_host_table_views_bf16_bits():
    """A uint16 table is read as bf16 (no copy); a table of another 16-bit
    type is refused."""
    bits = bf16_rows(np.linspace(-3, 3, 60, dtype=np.float32)
                     .reshape(12, 5), 8)
    t = HostTable(bits, pin=False)
    assert t.host.dtype == torch.bfloat16 and tuple(t.shape) == (12, 8)
    assert t.host.data_ptr() == bits.ctypes.data
    assert t.on("cpu").view(torch.int16).numpy().view(np.uint16).tobytes() \
        == bits.tobytes()
    for other in (np.int16, np.float16):
        with pytest.raises(ValueError, match="dtype"):
            HostTable(bits.view(other), pin=False)


def _k4(F, cache_dtype, C=10, V=40):
    """A K4 cache of rows 0 .. C-1 of a [V, F] f32 table, in cache_dtype."""
    rng = np.random.default_rng(F)
    feats = rng.standard_normal((V, F)).astype(np.float32)
    rows = torch.from_numpy(feats[:C]).to(cache_dtype)
    slot_map = torch.full((V,), -1, dtype=torch.int32)
    slot_map[:C] = torch.arange(C, dtype=torch.int32)
    return UnifiedCache(rows, slot_map, None, None, None, C, 0), feats


@pytest.mark.parametrize("kernel", ["cached_gather", "clique_gather"])
def test_wrappers_take_the_table_of_their_rows(kernel):
    """K4 and K13 take an f32 table for either cache dtype and a bf16 table
    (any pitch >= F) for a bf16 cache, with the same rows; they refuse a
    bf16 table for f32 rows, a pitch under the width and a table of
    another type (int32, as a CSR's)."""
    F = 12
    ids = torch.tensor([3, 25, -1, 39, 25, 0], dtype=torch.int32)

    def run(cache, table):
        host = HostTable(table, pin=False)
        if kernel == "cached_gather":
            return cached_gather(cache, host, ids)[0]
        lane_row = torch.where((ids >= 0) & (ids < 10), ids, -1)[None]
        return clique_gather(cache.cache_rows, lane_row, ids[None],
                             host)[0][0]

    for dt in (torch.float32, torch.bfloat16):
        cache, feats = _k4(F, dt)
        ref = run(cache, feats)
        assert ref.dtype == dt and not ref[2].any()
        bad = [feats[:, :F - 1].copy(),                 # f32, pitch < F
               bf16_rows(feats[:, :F - 1], F - 1),      # bf16, pitch < F
               bf16_rows(feats, 2 * F).view(np.int32)]  # another type
        if dt == torch.bfloat16:
            for P in (F, 16, 64):
                assert torch.equal(run(cache, bf16_rows(feats, P)), ref)
        else:
            bad.append(bf16_rows(feats, F))             # bf16 for f32 rows
        for table in bad:
            with pytest.raises(ValueError, match="host table"):
                run(cache, table)


def _host_cfg(ds, compute_dtype, mesh):
    return LegionConfig(
        dataset=ds.meta,
        sampler=SamplerConfig(fanouts=(4, 3), batch_size=64,
                              eval_batch_size=64, dedup="sort",
                              dedup_last_hop=False, neighbor_window=8),
        cache=CacheConfig(cache_bytes=60_000, presample_steps=2,
                          feature_residency="host", topo_residency="host"),
        train=TrainConfig(hidden_dim=16, epochs=1,
                          compute_dtype=compute_dtype,
                          pad_feature_dim=False),
        mesh=mesh)


@pytest.mark.parametrize("members", [1, 4])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_trainer_reads_a_table_of_its_cache_dtype(compute_dtype, members):
    """A bf16 cache gets the bf16 rows of the features at ``bf16_pitch``
    (``setup_s`` has the table's seconds and V * pitch * 2 bytes, and no
    f32 copy); an f32 cache gets the f32 array itself (no bf16 table).
    One member (K4) or a clique of four (K13); the trainer steps."""
    ds = synthesize_dataset(num_nodes=1200, avg_degree=8, feature_dim=100,
                            num_classes=4, batch_size=64, train_frac=0.5,
                            seed=5)
    mesh = MeshConfig.for_devices(1) if members == 1 else MeshConfig(1, 4)
    tr = Trainer(ds, _host_cfg(ds, compute_dtype, mesh), device="cpu")
    fs = tr.feature_source
    assert isinstance(fs, CachedFeatureSource if members == 1
                      else CliqueFeatureCache)
    V, F = ds.features.shape
    if compute_dtype == "bfloat16":
        P = bf16_pitch(F)
        assert P == 128 and fs.host.host.dtype == torch.bfloat16
        np.testing.assert_array_equal(fs.host.array, bf16_rows(ds.features,
                                                               P))
        assert tr.setup_s["bf16_table_bytes"] == V * P * 2 \
            == fs.host.array.nbytes
        assert tr.setup_s["bf16_table"] > 0.0
    else:
        assert fs.host.array is ds.features
        assert fs.host.host.dtype == torch.float32
        assert tr.setup_s["bf16_table"] == 0.0
        assert tr.setup_s["bf16_table_bytes"] == 0
    assert tr.setup_s["ram_copy_bytes"] == 0
    _, loss = tr.train_step(tr.init_state())
    assert np.isfinite(float(loss))
    tr.close()
