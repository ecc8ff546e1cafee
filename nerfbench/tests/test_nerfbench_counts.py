"""The frozen counts against hand arithmetic."""

import pytest

from nerfbench import counts, harness

PEAK = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}


def test_mlp_flops_per_sample():
    # trunk 60x256 + 6 x 256x256 + 316x256, sigma 256x1, feature 256x256,
    # view 280x128, color 128x3; two operations a multiply-add
    layers = [60 * 256] + [256 * 256] * 6 + [316 * 256, 256, 256 * 256, 280 * 128, 128 * 3]
    assert counts.mlp_flops_per_sample() == 2 * sum(layers) == 1_182_976


def test_kernel2_bound_at_4096_rays():
    """Kernel 2 over a step's 4096 rays x (64 + 128) samples: 2 x 1,182,976
    x 786,432 = 1.861 TFLOP, 1.88 ms at 989 TFLOP/s; the bytes (about 19
    MB) bound it far less."""
    flops = sum(counts.field_rays_bwd_work(4096, n)[0] for n in (64, 128))
    assert flops == 2 * 1_182_976 * 4096 * 192
    bound = sum(counts.bound_s(counts.field_rays_bwd_work(4096, n), PEAK) for n in (64, 128))
    assert bound == pytest.approx(1.8816e-3, rel=1e-3)
    nbytes = counts.field_rays_bwd_work(4096, 128)[1]
    assert nbytes == 4 * (6 * 4096 + 4096 * 128 * 6 + 2 * 593_924 + 6 * 4096)


def test_frame_and_step_flops():
    ini = {"N_COARSE": 64, "N_FINE": 128}
    model = harness.load_cell("train-lego_occ").reference()
    assert counts.frame_flops(model, ini, 800 * 800) == 1_182_976 * 640_000 * 192
    assert counts.train_step_flops(model, ini, 4096) == pytest.approx(2.79e12, rel=2e-3)


@pytest.mark.parametrize("config", harness.load_json(harness.BENCHMARK)["configs"],
                         ids=lambda c: c["name"])
def test_each_configuration_counts_its_own_work(config):
    """Every configuration's plain reference exports its counts, which the
    mfu readers take; lego_occ's by hand: one MLP a sample, 64 + 128
    samples a ray, 64**3 / 8 cells a refresh."""
    model = harness.load_module(f"{harness.BENCH_DIR}/configs/{config['name']}.py",
                                "counts_" + config["name"])
    ini = harness.load_json(f"{harness.ROOT}/{config['file']}")["ini"]
    assert model.forward_flops_per_ray(ini) > 0 and model.refresh_flops(ini) > 0
    if config["name"] == "lego_occ":
        assert model.forward_flops_per_ray(ini) == 192 * 1_182_976
        assert model.refresh_flops(ini) == 32_768 * 1_182_976


def test_peaks():
    assert counts.peaks("NVIDIA H100 80GB HBM3")["bf16_flops_per_s"] == 989e12
    assert counts.peaks("cpu") is None
