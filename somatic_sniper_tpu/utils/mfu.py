"""Chained-loop microbenchmark of the fast-path scoring kernel.

``bench_kernel`` measures the on-device rate of
models.somatic.call_batch_packed (glfgen + consensus + somatic score over
one (2, B, D) u32 slab), free of dispatch and transfer overhead: a
``lax.fori_loop`` chain whose per-iteration input depends on the previous
iteration's result (a data dependency, so XLA cannot hoist the loop body
out of the loop), with a runtime trip count so ONE executable serves
every iteration count.  Rate = B * (iters_hi - iters_lo) / (t_hi - t_lo):
differencing two trip counts cancels dispatch/fetch constants.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np


class KernelBench(NamedTuple):
    cols_per_sec: float
    measured_slab_s: float
    B: int
    D: int


def bench_kernel(B: int = 32768, D: int = 64, iters: int = 16,
                 use_joint: bool = False) -> KernelBench:
    """Measure the on-device rate of the production scoring kernel.

    One executable total: the iteration count is a runtime scalar
    (fori_loop lowers to while_loop), and the chained carry makes each
    iteration's input depend on the previous result.
    """
    import jax
    import jax.numpy as jnp
    from functools import partial

    from ..models.somatic import call_batch_packed
    from ..models.tables import ModelParams
    from ..runner import get_device_tables

    dtabs = get_device_tables(ModelParams(), "fast")
    p = dtabs.params

    rng = np.random.default_rng(7)
    depths = rng.integers(max(1, D // 2), D + 1, B).astype(np.int32)
    # raw u32 kept-only lanes (the production slab encoding):
    # mapq | baseq<<8 | base16<<16 | strand<<20
    mapq = rng.integers(1, 61, (B, D)).astype(np.uint32)
    baseq = rng.integers(1, 41, (B, D)).astype(np.uint32)
    base16 = np.asarray([1, 2, 4, 8], np.uint32)[
        rng.integers(0, 4, (B, D))
    ]
    strand = rng.integers(0, 2, (B, D)).astype(np.uint32)
    slots = mapq | (baseq << 8) | (base16 << 16) | (strand << 20)
    mask = np.arange(D)[None, :] < depths[:, None]
    stacked_h = np.where(mask[None], np.stack([slots, slots ^ 0x100]), 0)
    stacked_h = stacked_h.astype(np.uint32)
    ref16 = rng.choice([1, 2, 4, 8], size=B).astype(np.int32)
    cap = p.cap_mapq
    meta_h = np.zeros((3, B), np.int32)
    meta_h[0] = ref16 << 24
    mv = meta_h.view(np.uint32)
    mv[2] = (
        depths.astype(np.uint32)
        | (depths.astype(np.uint32) << 8)
        | (depths.astype(np.uint32) << 16)
        | (depths.astype(np.uint32) << 24)
    )

    core = partial(
        call_batch_packed,
        fk64=dtabs.fk, coef64=dtabs.coef, lhet64=dtabs.lhet,
        solo_prior=dtabs.solo_prior, joint_prior=dtabs.joint_prior,
        qadd_table=dtabs.qadd, q_r_int=dtabs.q_r_int,
        use_joint=use_joint, min_somatic_qual=p.min_somatic_qual,
        include_loh=p.include_loh, include_gor=p.include_gor,
        cap_mapq=cap, theta=p.theta, eta=p.eta, max_emit=B,
    )

    @jax.jit
    def chain(stacked, meta, n):
        def body(i, carry):
            acc, prev = carry
            # data-dependent perturbation: flips the low effq bit of
            # every slot based on the previous result — a real serial
            # dependency, so LICM cannot hoist the body
            s2 = stacked ^ (prev & 1).astype(jnp.uint32)
            res = core(s2, meta)
            return acc + res.count, res.count
        acc, _ = jax.lax.fori_loop(
            0, n, body, (jnp.int32(0), jnp.int32(0))
        )
        return acc

    stacked = jnp.asarray(stacked_h)
    meta = jnp.asarray(meta_h)
    # warm (compile + first execution)
    int(chain(stacked, meta, jnp.int32(1)))

    def timed(n):
        t0 = time.perf_counter()
        int(chain(stacked, meta, jnp.int32(n)))  # fetch forces the wait
        return time.perf_counter() - t0

    lo, hi = max(2, iters // 4), iters
    t_lo = min(timed(lo) for _ in range(2))
    t_hi = min(timed(hi) for _ in range(2))
    dt = max(t_hi - t_lo, 1e-9)
    return KernelBench(
        cols_per_sec=B * (hi - lo) / dt, measured_slab_s=dt / (hi - lo),
        B=B, D=D,
    )
