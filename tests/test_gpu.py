"""The fast scoring program as compiled for an NVIDIA GPU.

These tests need a card: they skip elsewhere, and chip_smoke.py runs them
on the GPU (``SNIPER_TEST_PLATFORM=cuda,cpu python -m pytest -m gpu
tests/test_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from somatic_sniper_tpu.models import tables as T
from somatic_sniper_tpu.models.somatic import COMPACT_FIELDS, call_batch_packed

pytestmark = pytest.mark.gpu

PM1 = {COMPACT_FIELDS.index(n) for n in (
    "tumor_cnsq", "normal_cnsq", "tumor_vaq", "normal_vaq", "somatic_score",
    "joint_cnsq")}


@pytest.fixture
def gpu():
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU backend")


def _slab(B, D, seed):
    """Random raw-u32 kept-only slab in the call_batch_packed layout."""
    rng = np.random.default_rng(seed)
    nk = rng.integers(0, D + 1, (2, B)).astype(np.uint32)
    base16 = np.asarray([1, 2, 4, 8], np.uint32)[rng.integers(0, 4, (2, B, D))]
    lanes = (rng.integers(0, 61, (2, B, D)).astype(np.uint32)
             | (rng.integers(0, 42, (2, B, D)).astype(np.uint32) << 8)
             | (base16 << 16)
             | (rng.integers(0, 2, (2, B, D)).astype(np.uint32) << 20))
    lanes = np.where(np.arange(D) < nk[..., None], lanes, 0)
    meta = np.zeros((3, B), np.uint32)
    meta[0] = rng.choice([1, 2, 4, 8], B).astype(np.uint32) << 24
    meta[2] = nk[0] | (nk[1] << 8) | (nk[0] << 16) | (nk[1] << 24)
    return lanes.astype(np.uint32), meta.view(np.int32)


def _score(device, lanes, meta, use_joint):
    tabs = T.build_tables(T.ModelParams())
    put = lambda x: jax.device_put(x, device)  # noqa: E731
    f32 = lambda x: put(jnp.asarray(x, jnp.float32))  # noqa: E731
    args = (put(lanes), put(meta), f32(tabs.fk), f32(tabs.coef),
            f32(tabs.lhet), put(tabs.solo_prior), put(tabs.joint_prior),
            put(tabs.qadd), tabs.q_r_int)
    res = call_batch_packed(*args, use_joint=use_joint,
                            max_emit=lanes.shape[1], row_dtype="u8")
    count, rows = jax.device_get((res.count, res.rows))
    return np.asarray(rows)[: int(count)].astype(np.int64), args


@pytest.mark.parametrize("use_joint", [False, True])
def test_gpu_scoring_matches_cpu(gpu, use_joint):
    """Same emitted columns and fields on the card as on the CPU
    backend; only the fast contract's +/-1 fields may differ, by 1."""
    lanes, meta = _slab(4096, 64, 5)
    got, _ = _score(gpu, lanes, meta, use_joint)
    want, _ = _score(jax.devices("cpu")[0], lanes, meta, use_joint)
    assert len(got) > 0
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    diff = np.abs(got[:, 2:] - want[:, 2:])
    bad = [j for j in np.unique(np.nonzero(diff)[1])
           if j not in PM1 or diff[:, j].max() > 1]
    assert not bad, bad


def test_gpu_program_has_no_matmul(gpu):
    """The compiled GPU program calls no matmul library and holds no
    dot: TF32 cannot reach the results."""
    lanes, meta = _slab(1024, 48, 7)
    _, args = _score(gpu, lanes, meta, False)
    hlo = call_batch_packed.lower(
        *args, max_emit=lanes.shape[1], row_dtype="u8"
    ).compile().as_text()
    assert "cublas" not in hlo.lower()
    assert " dot(" not in hlo
