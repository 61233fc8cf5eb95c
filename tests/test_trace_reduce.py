"""The trace reduction of benchmarks/trace_aac_step.py: interval
union, and the refusal of a trace with no GPU kernels."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "benchmarks"))
import trace_aac_step as tr  # noqa: E402


@pytest.mark.parametrize("intervals,busy", [
    ([(0, 10), (20, 30)], 20),            # disjoint
    ([(0, 10), (5, 15), (12, 20)], 20),   # chained overlaps
    ([(0, 100), (10, 20), (30, 40)], 100),  # nested
    ([], 0),
])
def test_union_of_kernel_intervals(intervals, busy):
    assert tr._union_ns(intervals) == busy


def test_reduce_refuses_a_trace_without_gpu_kernels(tmp_path):
    import glob

    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((64, 64))
    f(x).block_until_ready()
    jax.profiler.start_trace(str(tmp_path))
    f(x).block_until_ready()
    jax.profiler.stop_trace()
    path = glob.glob(str(tmp_path / "**" / "*.xplane.pb"), recursive=True)[0]
    with pytest.raises(RuntimeError, match="no GPU kernel events"):
        tr.reduce_trace(path, batches=1)
