"""Parity of the port's robust losses and scalers (`vslam_tpu_torch.solvers.
loss`, `core.image.masked_median`) with the JAX package.

Residuals and masks are drawn from numpy seeds: heavy-tailed residuals (a
Gaussian core plus outliers), exact zeros as invisible points carry, and
masks that keep all, some, one or none of the entries. The port reduces
over the last axis with leading rows independent, so each case runs as one
row and as a batch of rows, each row against its own JAX call.
Tolerances: weights rtol 1e-6 (one elementwise formula); scales rtol 1e-5
(sums in another order; the t-dist fixed point stops at a step of 1e-5).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vslam_tpu.core.image import masked_median as j_masked_median
from vslam_tpu.solvers import loss as jloss
from vslam_tpu_torch.core.image import masked_median
from vslam_tpu_torch.solvers import loss as tloss

N = 257
MASKS = ["all", "some", "one", "none"]


def _residuals(seed, n=N):
    rng = np.random.default_rng(seed)
    r = rng.normal(0.0, 6.0, n)
    out = rng.random(n) < 0.15
    r[out] = rng.uniform(-120.0, 120.0, out.sum())
    r[rng.random(n) < 0.1] = 0.0  # invisible points enter with r = 0
    return r.astype(np.float32)


def _mask(kind, seed, n=N):
    rng = np.random.default_rng(seed + 100)
    if kind == "all":
        return np.ones(n, bool)
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "one":
        m = np.zeros(n, bool)
        m[rng.integers(n)] = True
        return m
    return rng.random(n) < 0.6


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("n", [N, 256])  # odd and even counts
def test_masked_median_matches_jax(mask_kind, n):
    r, m = _residuals(1, n), _mask(mask_kind, 1, n)
    got = masked_median(torch.as_tensor(r), torch.as_tensor(m)).item()
    want = float(j_masked_median(jnp.asarray(r), jnp.asarray(m)))
    assert got == want


@pytest.mark.parametrize(
    "name,fn_t,fn_j",
    [
        ("huber", lambda r: tloss.huber_weight(r, 1.345), lambda r: jloss.huber_weight(r, 1.345)),
        ("huber_c2", lambda r: tloss.huber_weight(r, 2.0), lambda r: jloss.huber_weight(r, 2.0)),
        ("tukey", tloss.tukey_weight, jloss.tukey_weight),
        ("t_dist", lambda r: tloss.t_dist_weight(r, 5.0), lambda r: jloss.t_dist_weight(r, 5.0)),
        ("t_dist_v3", lambda r: tloss.t_dist_weight(r, 3.0), lambda r: jloss.t_dist_weight(r, 3.0)),
    ],
)
def test_weights_match_jax(name, fn_t, fn_j):
    r = _residuals(2) / 5.0  # standardized scale: inliers and outliers of every cutoff
    got = fn_t(torch.as_tensor(r)).numpy()
    want = np.asarray(fn_j(jnp.asarray(r)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if name.startswith("huber"):  # the reference's 1/|r| outlier weight
        c = 2.0 if name == "huber_c2" else 1.345
        out = np.abs(r) >= c
        np.testing.assert_allclose(got[out], 1.0 / np.abs(r[out]), rtol=1e-6)


SCALERS = {
    "median": (tloss._median_scale, jloss._median_scale),
    "mean": (tloss._mean_scale, jloss._mean_scale),
    "mad": (tloss._mad_scale, jloss._mad_scale),
    "t_dist": (tloss._t_dist_scale, jloss._t_dist_scale),
}


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("scaler", list(SCALERS))
def test_scales_match_jax(scaler, mask_kind):
    fn_t, fn_j = SCALERS[scaler]
    r, m = _residuals(3), _mask(mask_kind, 3)
    got = fn_t(torch.as_tensor(r), torch.as_tensor(m))
    want = fn_j(jnp.asarray(r), jnp.asarray(m))
    np.testing.assert_allclose(got.offset.item(), float(want.offset), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.scale.item(), float(want.scale), rtol=1e-5)
    if mask_kind == "none" and scaler != "t_dist":
        assert (got.offset.item(), got.scale.item()) == (0.0, 1.0)


@pytest.mark.parametrize("scaler", list(SCALERS))
def test_scales_of_a_batch_are_per_row(scaler):
    """Rows of a (3, 2, N) batch scale independently: each equals its JAX
    call, including an empty row and a row whose fixed point stops early."""
    fn_t, fn_j = SCALERS[scaler]
    r = np.stack([_residuals(10 + k) * (0.01 if k == 4 else 1.0) for k in range(6)]).reshape(3, 2, N)
    m = np.stack([_mask(MASKS[k % 4], 10 + k) for k in range(6)]).reshape(3, 2, N)
    got = fn_t(torch.as_tensor(r), torch.as_tensor(m))
    assert got.offset.shape == got.scale.shape == (3, 2)
    for i in range(3):
        for j in range(2):
            want = fn_j(jnp.asarray(r[i, j]), jnp.asarray(m[i, j]))
            np.testing.assert_allclose(got.offset[i, j].item(), float(want.offset), rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(got.scale[i, j].item(), float(want.scale), rtol=1e-5)


@pytest.mark.parametrize(
    "function,scaler",
    [("Huber", "reference"), ("Tukey", "reference"), ("tdistribution", "reference"),
     ("Huber", "mad"), ("Tukey", "mad"), ("Huber", "mean"), ("Tukey", "mean"),
     ("tdistribution", "mad"), ("None", "reference")],
)
def test_compute_scale_and_weights_dispatch(function, scaler):
    """compute_scale / compute_weights pick the same scaler and weight as
    the JAX package; tdistribution keeps its own scale whatever `scaler`
    says."""
    jcfg = jloss.LossConfig(function, huber_c=1.5, tdistribution_v=4.0, scaler=scaler)
    tcfg = tloss.LossConfig(**dataclasses.asdict(jcfg))
    r, m = _residuals(4), _mask("some", 4)
    got = tloss.compute_scale(tcfg, torch.as_tensor(r), torch.as_tensor(m))
    want = jloss.compute_scale(jcfg, jnp.asarray(r), jnp.asarray(m))
    np.testing.assert_allclose(got.offset.item(), float(want.offset), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.scale.item(), float(want.scale), rtol=1e-5)
    r_std = (r - float(want.offset)) / float(want.scale)
    np.testing.assert_allclose(tloss.compute_weights(tcfg, torch.as_tensor(r_std)).numpy(),
                               np.asarray(jloss.compute_weights(jcfg, jnp.asarray(r_std))),
                               rtol=1e-6)


def test_loss_config_matches_jax_defaults():
    assert dataclasses.asdict(tloss.LossConfig()) == dataclasses.asdict(jloss.LossConfig())
    assert tloss.TUKEY_C == jloss.TUKEY_C
