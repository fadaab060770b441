"""The benchmark's frozen ESS and R-hat against the program's own
``walnuts_tpu_torch.summary`` on seeded series (the test may import the
program; the benchmark's reference does not)."""

import numpy as np
import pytest

from portbench.reference import ess as ess_ref
from walnuts_tpu_torch import summary


def _series(seed, s, c, d, phi):
    rng = np.random.default_rng(seed)
    x = np.empty((s, c, d))
    x[0] = rng.standard_normal((c, d))
    for t in range(1, s):
        x[t] = phi * x[t - 1] + np.sqrt(1 - phi**2) * rng.standard_normal((c, d))
    return x + rng.standard_normal(d) * 0.1


@pytest.mark.parametrize("seed,s,c,d,phi", [
    (1, 20, 64, 5, 0.0), (2, 25, 128, 7, 0.6), (3, 200, 8, 3, 0.9),
    (4, 6, 32, 4, -0.4), (5, 3, 16, 2, 0.3), (2**31 + 5, 57, 40, 29, 0.95)])
def test_ess_matches_the_program_summary(seed, s, c, d, phi):
    x = _series(seed, s, c, d, phi)
    got = ess_ref.ess(x)
    want = summary.ess(np.transpose(x, (1, 0, 2)))
    np.testing.assert_allclose(got, want, rtol=1e-10)


@pytest.mark.parametrize("seed", [11, 12])
def test_r_hat_matches_the_program_summary(seed):
    x = _series(seed, 30, 16, 6, 0.5)
    np.testing.assert_allclose(ess_ref.r_hat(x), summary.r_hat(np.transpose(x, (1, 0, 2))),
                               rtol=1e-12)
