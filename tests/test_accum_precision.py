"""Long-run precision of the f32 conditional-sum accumulators.

Regression: ql_at_q / ql2_at_q / top4_frac used to accumulate as raw f32
scatter-adds across an entire sample(); at reference budgets (tens of
thousands of recorded sweeps into hot bins) per-bin sums lose precision.
The engine now folds per-chunk f32 sums into Kahan-compensated totals at
every chunk boundary (engine/loop.py fold_float_hists).

Oracle: the SAME trajectory (counter-based RNG is chunk-invariant) sampled
in 50 x 1k-sweep calls, each drained to the host f64 accumulator — so the
oracle's f32 spans are 1k sweeps, effectively exact — must match one
50k-sweep sample() to near-f64 tolerance.
"""

import numpy as np
import pytest

from peapods_tpu.engine.simulation import IsingSimulation

N_TOTAL = 50_000
N_PER = 1_000


def _sim():
    coup = np.ones((4, 4, 2), np.float32)
    temps = np.array([2.6], np.float32)
    return IsingSimulation([4, 4], coup, temps, 2, None, 123,
                           default_chunk=1024, mesh=None)


@pytest.mark.slow
def test_conditional_sums_match_f64_oracle_over_50k_sweeps():
    one = _sim()
    r_one = one.sample(N_TOTAL, "metropolis", warmup_ratio=0)

    many = _sim()
    ql = np.zeros_like(r_one["ql_at_q_sum"])
    ql2 = np.zeros_like(ql)
    hist = np.zeros_like(np.asarray(r_one["overlap_histogram"], np.uint64))
    for _ in range(N_TOTAL // N_PER):
        r = many.sample(N_PER, "metropolis", warmup_ratio=0)
        ql += r["ql_at_q_sum"]
        ql2 += r["ql2_at_q_sum"]
        hist += np.asarray(r["overlap_histogram"], np.uint64)

    # identical trajectory -> identical integer histogram
    np.testing.assert_array_equal(
        np.asarray(r_one["overlap_histogram"], np.uint64), hist
    )
    # conditional float sums: hot bins hold O(50k) adds; raw f32 would be
    # off by O(1e-2) relative — Kahan-folded totals must hit ~1e-6
    scale = max(1.0, np.abs(ql).max())
    assert np.abs(r_one["ql_at_q_sum"] - ql).max() / scale < 1e-5
    scale2 = max(1.0, np.abs(ql2).max())
    assert np.abs(r_one["ql2_at_q_sum"] - ql2).max() / scale2 < 1e-5
