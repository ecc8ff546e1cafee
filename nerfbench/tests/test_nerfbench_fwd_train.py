"""``field_rays_fwd_roofline.train``'s work against hand arithmetic, and its
reading of a made-up traced span."""

from types import SimpleNamespace

import pytest

from nerfbench import counts, harness
from nerfbench.trace import Span

PEAK = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
READER = harness.metric_reader("field_rays_fwd_roofline.train")


def test_residual_bytes():
    # 2,516 bf16 layer inputs and a float32 sign a sample
    assert READER.RESIDUAL_BYTES == 2 * 2516 + 4 == 5036


def test_bound_at_4096_rays():
    """A step's 4096 rays x (64 + 128) samples: 0.930 TFLOP (0.940 ms at 989
    TFLOP/s) against 786,432 x (5,036 + 20) bytes and the rays and weights
    (3.981 GB, 1.188 ms at 3.35 TB/s): the residuals' writes bound it."""
    rows = 4096 * 192
    flops = sum(READER.work(counts, 4096, n)[0] for n in (64, 128))
    assert flops == 1_182_976 * rows
    nbytes = sum(READER.work(counts, 4096, n)[1] for n in (64, 128))
    assert nbytes == rows * (5036 + 4 * 5) + 2 * 4 * (6 * 4096 + 593_924)
    bound = sum(counts.bound_s(READER.work(counts, 4096, n), PEAK) for n in (64, 128))
    assert bound == pytest.approx(nbytes / PEAK["hbm_bytes_per_s"])
    assert bound == pytest.approx(1.1884e-3, rel=1e-3)


def _run(kind="train", kernel_s=None, calls=20):
    span = Span(wall_s=1.0, window_s=1.0, busy_s=1.0, calls=calls,
                kernel_s=kernel_s or {})
    return SimpleNamespace(kind=kind, field="mlp", peak=PEAK, spans=[span], calls=calls,
                           counts=counts, traffic={"ranks": 1},
                           ini={"BATCH_RAY": 4096, "N_COARSE": 64, "N_FINE": 128})


def test_reads_the_forwards_kernels_by_name():
    # 20 steps at 11.88 ms of kernel 1 each: a tenth of the bound
    run = _run(kernel_s={"field_rays_fwd_kernel": 0.2, "pack_kernel": 0.0376,
                         "field_bwd_tc_kernel": 5.0})
    bound = sum(counts.bound_s(READER.work(counts, 4096, n), PEAK) for n in (64, 128))
    assert READER.read(run) == pytest.approx(100.0 * bound * 20 / 0.2376)


@pytest.mark.parametrize("run", [_run(kind="render", kernel_s={"field_rays_fwd_kernel": 1.0}),
                                 _run(kernel_s={"field_bwd_tc_kernel": 1.0})],
                         ids=["render", "no_kernel_1"])
def test_reads_nothing_elsewhere(run):
    assert READER.read(run) is None
