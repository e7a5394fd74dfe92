"""Fast (f32) glfgen path: slot encodings, gather lookups, mesh sharding.

Every table lookup of the fast scoring program is a gather.  The
program it replaced did the same lookups as one-hot contractions at
HIGHEST precision; those contractions are kept here as the oracle, and
the gathers must reproduce them bit for bit at every slab depth and
in both fast slot encodings.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from somatic_sniper_tpu.models import consensus
from somatic_sniper_tpu.models import glfgen
from somatic_sniper_tpu.models import tables as T
from somatic_sniper_tpu.models.glfgen import (
    ColumnBatch,
    glfgen_batch,
    pack_slots_np,
)

F32 = jnp.float32
HI = jax.lax.Precision.HIGHEST


def _random_batch(B, D, seed, p_del=0.05, p_ambig=0.05, p_q0=0.05):
    rng = np.random.default_rng(seed)
    depths = rng.integers(0, D + 1, B).astype(np.int32)
    base = rng.choice([1, 2, 4, 8, 15, 5, 0], size=(B, D),
                      p=[.3, .25, .2, .13, .04, .04, .04])
    baseq = np.where(rng.random((B, D)) < p_q0, 0,
                     rng.integers(0, 94, (B, D)))
    mapq = rng.integers(0, 256, (B, D))
    strand = rng.integers(0, 2, (B, D))
    is_del = rng.random((B, D)) < p_del
    slots = pack_slots_np(base, baseq, mapq, strand, is_del)
    mask = np.arange(D)[None, :] < depths[:, None]
    slots = np.where(mask, slots, 0).astype(np.uint32)
    ref16 = rng.choice([1, 2, 4, 8, 15], size=B).astype(np.int32)
    return ColumnBatch(
        slots=jnp.asarray(slots),
        depth=jnp.asarray(depths),
        ref16=jnp.asarray(ref16),
    )


def _to_packed16(cb: ColumnBatch, cap_mapq=60) -> ColumnBatch:
    """Reference conversion u32 -> compact u16 ColumnBatch (numpy)."""
    s = np.asarray(cb.slots)
    depth = np.asarray(cb.depth)
    ref16 = np.asarray(cb.ref16)
    B, D = s.shape
    out = np.zeros((B, D), np.uint16)
    nk = np.zeros(B, np.int32)
    rms = np.zeros(B, np.int32)
    for b in range(B):
        k = 0
        for j in range(int(depth[b])):
            w = int(s[b, j])
            if (w >> 21) & 1:
                continue
            mq, q = w & 0xFF, (w >> 8) & 0xFF
            b16 = (w >> 16) & 0xF
            code = b16 if b16 else int(ref16[b])
            base2 = {1: 0, 2: 1, 4: 2, 8: 3}.get(code, 0)
            eff = min(q, mq)
            if eff < 4 and (q & 0x3F) != 0:
                eff = 4
            out[b, k] = eff | (base2 << 8) | (((w >> 20) & 1) << 10)
            k += 1
            rms[b] += min(mq & 0x7F, cap_mapq) ** 2
        nk[b] = k
    return ColumnBatch(
        slots=jnp.asarray(out), depth=cb.depth, ref16=cb.ref16,
        n_keep=jnp.asarray(nk), rms_sum=jnp.asarray(rms),
    )


def _to_raw32(cb: ColumnBatch) -> ColumnBatch:
    """Reference conversion u32 -> raw kept-only slab lanes (numpy):
    drop deletion entries, mask to the 21 packing bits, left-pack."""
    s = np.asarray(cb.slots)
    depth = np.asarray(cb.depth)
    B, D = s.shape
    out = np.zeros((B, D), np.uint32)
    nk = np.zeros(B, np.int32)
    for b in range(B):
        k = 0
        for j in range(int(depth[b])):
            w = int(s[b, j])
            if (w >> 21) & 1:
                continue
            out[b, k] = w & 0x1FFFFF
            k += 1
        nk[b] = k
    return ColumnBatch(
        slots=jnp.asarray(out), depth=cb.depth, ref16=cb.ref16,
        n_keep=jnp.asarray(nk),
    )


def test_glfgen_packed16_matches_u32():
    """The compact u16 encoding must reproduce the u32 fast path: equal
    (class, effq) reads are interchangeable, everything else is exact."""
    tabs = T.build_tables(T.ModelParams())
    cb = _random_batch(128, 24, 11)
    cb16 = _to_packed16(cb)
    g_u32 = glfgen_batch(cb, tabs.fk, tabs.coef, tabs.lhet,
                         precision="fast")
    g_u16 = glfgen_batch(cb16, tabs.fk, tabs.coef, tabs.lhet,
                         precision="fast")
    np.testing.assert_array_equal(np.asarray(g_u16.depth),
                                  np.asarray(g_u32.depth))
    np.testing.assert_array_equal(np.asarray(g_u16.rms_mapq),
                                  np.asarray(g_u32.rms_mapq))
    diff = np.abs(np.asarray(g_u16.lk).astype(int)
                  - np.asarray(g_u32.lk).astype(int))
    assert diff.max() <= 1  # f32 sum-order noise at quantization edges
    assert (diff == 0).all(axis=1).mean() > 0.99


def test_glfgen_raw32_matches_u32():
    """The raw kept-only slab encoding must reproduce the plain u32
    fast path (the fill only drops deletion entries, which never reach
    the accumulators)."""
    tabs = T.build_tables(T.ModelParams())
    cb = _random_batch(128, 24, 13)
    cb32 = _to_raw32(cb)
    g_u32 = glfgen_batch(cb, tabs.fk, tabs.coef, tabs.lhet,
                         precision="fast")
    g_raw = glfgen_batch(cb32, tabs.fk, tabs.coef, tabs.lhet,
                         precision="fast")
    np.testing.assert_array_equal(np.asarray(g_raw.depth),
                                  np.asarray(g_u32.depth))
    np.testing.assert_array_equal(np.asarray(g_raw.rms_mapq),
                                  np.asarray(g_u32.rms_mapq))
    diff = np.abs(np.asarray(g_raw.lk).astype(int)
                  - np.asarray(g_u32.lk).astype(int))
    assert diff.max() <= 1  # f32 sum-order noise at quantization edges
    assert (diff == 0).all(axis=1).mean() > 0.99


def test_pad16_native_matches_numpy(data_dir):
    from somatic_sniper_tpu.io import native_api
    from somatic_sniper_tpu.pileup.columnize import (
        ColumnarPileup, _pad_columns16,
    )

    f = str(data_dir / "e2e/sim1/tumor.bam")
    _, pu = native_api.load_and_columnize(f)
    rng = np.random.default_rng(3)
    idx = np.sort(rng.choice(len(pu.ukeys), 2000, replace=False))
    ref16 = rng.choice([1, 2, 4, 8, 15], size=len(idx)).astype(np.int32)
    D = int(pu.depths[idx].max())
    nat = _pad_columns16(pu, idx, ref16, D, 60)
    pu_py = ColumnarPileup(keys=None, slots=np.asarray(pu.slots).copy(),
                           ukeys=np.asarray(pu.ukeys).copy(),
                           offsets=np.asarray(pu.offsets).copy())
    pyt = _pad_columns16(pu_py, idx, ref16, D, 60)
    for a, b in zip(nat, pyt):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------ one-hot HIGHEST oracle


def _onehot_take_rows(table, idx):
    oh = jax.nn.one_hot(idx, table.shape[1], dtype=F32)
    return jnp.einsum("bjk,bk->bj", oh, table.astype(F32),
                      precision=HI).astype(table.dtype)


def _onehot_coef_at(coef, bar_e, c_tot, tmp2):
    NK = coef.shape[1]
    R = jnp.einsum("bm,emk->bek", jax.nn.one_hot(c_tot, NK, dtype=F32),
                   coef[4:64], precision=HI)
    oe = jax.nn.one_hot(bar_e - 4, 60, dtype=F32)
    ok = jax.nn.one_hot(tmp2, NK, dtype=F32)
    return jnp.einsum("bte,bek,btk->bt", oe, R, ok, precision=HI)


def _onehot_lhet_at(lhet, cj, ck):
    NK = lhet.shape[0]
    rows = jnp.einsum("btm,mk->btk", jax.nn.one_hot(cj, NK, dtype=F32),
                      lhet, precision=HI)
    return (rows * jax.nn.one_hot(ck, NK, dtype=F32)).sum(-1)


def _onehot_row_select(table, idx):
    t = jnp.asarray(table)
    oh = jax.nn.one_hot(idx, t.shape[0], dtype=F32)
    flat = t.reshape(t.shape[0], -1).astype(F32)
    out = jnp.matmul(oh, flat, precision=HI)
    return out.reshape((idx.shape[0],) + t.shape[1:]).astype(t.dtype)


@pytest.mark.parametrize("encoding", ["raw32", "u16"])
@pytest.mark.parametrize("D", [16, 32, 48, 64, 128])
def test_gather_lookups_match_onehot_oracle(monkeypatch, D, encoding):
    """glfgen's gathers (within-class rank offsets, the ten coef terms,
    the six lhet terms) return exactly what the one-hot HIGHEST
    contractions returned: lk, min_lk, depth and rms are bit-equal."""
    tabs = T.build_tables(T.ModelParams())
    cb = _random_batch(96, D, 100 + D)
    cb = _to_raw32(cb) if encoding == "raw32" else _to_packed16(cb)

    def run():
        jax.clear_caches()  # the lookups are read at trace time
        g = glfgen_batch(cb, tabs.fk, tabs.coef, tabs.lhet,
                         precision="fast")
        return [np.asarray(x) for x in g]

    got = run()
    monkeypatch.setattr(glfgen, "_take_rows", _onehot_take_rows)
    monkeypatch.setattr(glfgen, "_coef_at", _onehot_coef_at)
    monkeypatch.setattr(glfgen, "_lhet_at", _onehot_lhet_at)
    want = run()
    jax.clear_caches()
    assert (got[0] > 0).any(), "batch must exercise the likelihoods"
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("table", ["solo_prior", "joint_prior"])
def test_row_select_matches_onehot_oracle(table):
    t = getattr(T.build_tables(T.ModelParams()), table)
    idx = jnp.asarray(np.arange(64) % 16, jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(consensus._row_select(t, idx)),
        np.asarray(_onehot_row_select(t, idx)),
    )


@pytest.mark.parametrize("use_joint", [False, True])
@pytest.mark.parametrize("lanes", [np.uint32, np.uint16])
def test_fast_program_has_no_dot(lanes, use_joint):
    """No matmul in the fast scoring program: TF32 (or any reduced
    matmul precision) cannot reach the results."""
    from somatic_sniper_tpu.models.somatic import call_batch_packed

    tabs = T.build_tables(T.ModelParams())
    B, D = 64, 32
    text = call_batch_packed.lower(
        jnp.zeros((2, B, D), lanes), jnp.zeros((3, B), jnp.int32),
        jnp.asarray(tabs.fk, F32), jnp.asarray(tabs.coef, F32),
        jnp.asarray(tabs.lhet, F32), jnp.asarray(tabs.solo_prior),
        jnp.asarray(tabs.joint_prior), jnp.asarray(tabs.qadd),
        tabs.q_r_int, use_joint=use_joint, row_dtype="u8",
    ).as_text()
    assert "gather" in text
    assert "dot" not in text


# ------------------------------------------------------- mesh sharding


def _mesh8():
    from somatic_sniper_tpu.parallel.sharding import make_mesh

    if jax.device_count() < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def _shard(cb: ColumnBatch, mesh) -> ColumnBatch:
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x):
        spec = P("data") if x.ndim == 1 else P("data", None)
        return jax.device_put(x, NamedSharding(mesh, spec))

    return ColumnBatch(*(None if x is None else put(x) for x in cb))


def test_glfgen_mesh_matches_single_device():
    """With batch-sharded inputs the fast glfgen partitions under GSPMD
    (one slab per device) and must reproduce the single-device result
    bit for bit."""
    mesh = _mesh8()
    tabs = T.build_tables(T.ModelParams())
    cb = _to_raw32(_random_batch(256, 32, 13))
    g_one = glfgen_batch(cb, tabs.fk, tabs.coef, tabs.lhet,
                         precision="fast")
    g_mesh = glfgen_batch(_shard(cb, mesh), tabs.fk, tabs.coef, tabs.lhet,
                          precision="fast")
    for a, b in zip(g_mesh, g_one):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_glfgen_mesh_packed16_matches_single_device():
    mesh = _mesh8()
    tabs = T.build_tables(T.ModelParams())
    cb16 = _to_packed16(_random_batch(128, 24, 17))
    g_one = glfgen_batch(cb16, tabs.fk, tabs.coef, tabs.lhet,
                         precision="fast")
    g_mesh = glfgen_batch(_shard(cb16, mesh), tabs.fk, tabs.coef,
                          tabs.lhet, precision="fast")
    for a, b in zip(g_mesh, g_one):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_sharded_call_batch_matches_single_device():
    """The production mesh dispatch (sharded_call_batch) makes the same
    calls, bit for bit, as the unsharded step."""
    from somatic_sniper_tpu.models.somatic import call_batch
    from somatic_sniper_tpu.parallel.sharding import sharded_call_batch

    mesh = _mesh8()
    tabs = T.build_tables(T.ModelParams())
    tb = _random_batch(128, 32, 19)
    nb = _random_batch(128, 32, 23)
    targs = (tabs.fk.astype(np.float32), tabs.coef.astype(np.float32),
             tabs.lhet.astype(np.float32), tabs.solo_prior,
             tabs.joint_prior, tabs.qadd, tabs.q_r_int)
    r_mesh = sharded_call_batch(mesh, tb, nb, targs, precision="fast",
                                use_joint=True)
    r_one = call_batch(tb, nb, *targs, precision="fast", use_joint=True)
    for a, b in zip(r_mesh, r_one):
        if a is None:
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(r_one.emit).any()
