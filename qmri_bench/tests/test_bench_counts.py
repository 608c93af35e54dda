import pytest

from qmri_bench import counts


@pytest.mark.parametrize("n,t", [(512 * 512 * 64, 4), (192 * 192 * 48, 4), (1000, 8)])
def test_monoexp_work_from_shapes(n, t):
    nbytes, flops = counts.monoexp_fit_work(n, t)
    assert nbytes == 4 * t * n + 16 * n
    it = counts.MONOEXP_ITERATIONS
    assert flops == n * ((8 * t + 10) + it * (20 * t + 40) + (6 * t + 10))


def test_least_time_takes_the_larger_bound():
    assert counts.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 67e12) == pytest.approx(1.0)
    # config1 is bound by bytes: 537 MB over 3.35 TB/s.
    nbytes, flops = counts.monoexp_fit_work(512 * 512 * 64, 4)
    assert counts.least_seconds(nbytes, flops) == pytest.approx(nbytes / 3.35e12)
    assert counts.least_seconds(nbytes, flops) == pytest.approx(1.6025e-4, rel=1e-3)
