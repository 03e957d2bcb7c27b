"""The operation and byte counts against counts made by hand at tiny
shapes."""

import pytest

from port_bench.counts import fast_ica, randomized_pca

RPCA = {"data": {"n": 10, "d": 4},
        "model": {"n_components": 1, "n_oversamples": 1, "n_power_iters": 1}}
ICA = {"data": {"n": 10, "d": 3}, "model": {}}


def test_randomized_pca_parts_by_hand():
    # n = 10, d = 4, k = 1, l = 2, q = 1.
    # Moments: the Gram n·d·(d+1) = 200, sums and squares 3·n·d = 120.
    assert randomized_pca.moments_ops(10, 4) == 320
    # A thin QR of 4 × 2: 4·4·2² − (4/3)·2³ = 64 − 32/3.
    assert randomized_pca.qr_ops(4, 2) == pytest.approx(64 - 32 / 3)
    # Subspace: one G·W (2·4²·2 = 64) and two QRs; recovery: G·W 64,
    # WᵀGW and (GW)ᵀGW 2·(2·4·2²) = 64, two eighs 2·9·2³ = 144, the
    # l × l products 4·2³ + 2·2³ = 48, V 2·4·2² = 32 and one QR.
    qr = 64 - 32 / 3
    assert randomized_pca.solve_ops(4, 2, 1) == pytest.approx(
        64 + 2 * qr + 64 + 64 + 144 + 48 + 32 + qr)


def test_randomized_pca_fit_by_hand():
    solve = 64 + 2 * (64 - 32 / 3) + 352 + (64 - 32 / 3)
    # fit adds U = Xc·V·Σ⁻¹: 2·n·d·l = 160 and the scaling n·l·2 = 40.
    assert randomized_pca.fit_ops(RPCA, "fit") == pytest.approx(320 + solve + 200)
    assert randomized_pca.fit_ops(RPCA, "fit_batched") == pytest.approx(320 + solve)


def test_gram_pass_by_hand():
    assert randomized_pca.gram_pass_ops(10, 4) == 320
    # X read once (10·4·4 bytes) and the 4 × 4 Gram written once.
    assert randomized_pca.gram_pass_bytes(10, 4, 4) == 160 + 64


def test_fast_ica_by_hand():
    # n = 10, d = k = 3.  Whitening: means 30, Gram 10·3·4 = 120, eigh
    # 9·27 = 243, X₁ = K·Xcᵀ 2·3·3·10 = 180.
    assert fast_ica.whitening_ops(10, 3, 3) == 573
    # A step: W·X₁ and g·X₁ᵀ 4·9·10 = 360, g′ sums 2·3·10 = 60, the
    # decorrelation (2 + 9 + 4)·27 = 405.
    assert fast_ica.iteration_ops(10, 3) == 825
    # Two steps and the first decorrelation of W₀.
    assert fast_ica.fit_ops(ICA, "fit", 2) == 573 + 2 * 825 + 405


def test_the_north_star_count_is_the_gram():
    cfg = {"data": {"n": 1 << 20, "d": 4096},
           "model": {"n_components": 32, "n_oversamples": 10, "n_power_iters": 7}}
    ops = randomized_pca.fit_ops(cfg, "fit")
    gram = (1 << 20) * 4096 * 4097
    assert gram < ops < 1.03 * gram
