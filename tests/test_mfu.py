"""Kernel microbench mechanics (utils.mfu).

Device rates come only from a GPU run; these tests pin the harness
mechanics on CPU: the chained fori_loop must execute with a runtime trip
count (one executable) and report a positive rate for the shape asked.
"""

from somatic_sniper_tpu.utils import mfu


def test_bench_kernel_runs_on_cpu():
    r = mfu.bench_kernel(B=128, D=16, iters=4)
    assert r.cols_per_sec > 0
    assert r.measured_slab_s > 0
    assert r.B == 128 and r.D == 16
