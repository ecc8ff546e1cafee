"""The trace's reduction on a hand-made Chrome trace."""

import pytest

from nerfbench import trace


def _x(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "args": args}


def events(lose_one=False):
    ev = [_x(trace.WINDOW, "user_annotation", 100.0, 100.0),
          _x("cudaGraphLaunch", "cuda_runtime", 101.0, 2.0, correlation=1),
          _x("cudaGraphLaunch", "cuda_runtime", 140.0, 2.0, correlation=2),
          _x("cudaMemcpyAsync", "cuda_runtime", 150.0, 1.0, correlation=3),
          _x("aten::clone", "cpu_op", 160.0, 20.0),
          # graph 1: two overlapping kernels on two streams, and one more
          _x("void field_bwd_tc_kernel<true>(Coord, float const*)", "kernel", 105.0, 10.0,
             correlation=1),
          _x("void at::native::reduce_kernel<512, 1>(float*)", "kernel", 110.0, 10.0,
             correlation=1),
          _x("reduce_kernel", "kernel", 125.0, 5.0, correlation=1),
          # graph 2
          _x("void field_bwd_tc_kernel<true>(Coord, float const*)", "kernel", 145.0, 10.0,
             correlation=2),
          _x("void at::native::reduce_kernel<512, 1>(float*)", "kernel", 150.0, 10.0,
             correlation=2),
          _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 190.0, 20.0, correlation=3)]
    if not lose_one:
        ev.append(_x("reduce_kernel", "kernel", 165.0, 5.0, correlation=2))
    return ev


def test_busy_is_the_union_clipped_to_the_window():
    s = trace.summarise(events(), wall_s=1e-4, calls=2)
    # [105, 120] + [125, 130] + [145, 160] + [165, 170] + [190, 200] (clipped) = 50 us
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(50e-6)
    assert s.idle_pct == pytest.approx(50.0)
    assert not s.records_lost


def test_kernels_by_bare_name_and_launches():
    s = trace.summarise(events(), wall_s=1e-4, calls=2)
    assert s.kernel_s["field_bwd_tc_kernel"] == pytest.approx(20e-6)
    assert s.kernel_s["reduce_kernel"] == pytest.approx(10e-6)
    assert s.kernel_s["at::native::reduce_kernel"] == pytest.approx(20e-6)
    assert s.kernels_named(("reduce_kernel", "field_bwd_tc_kernel")) == pytest.approx(30e-6)
    assert s.launches == 3
    assert s.idle_gaps and s.device_ops[0][0] in ("field_bwd_tc_kernel",
                                                  "at::native::reduce_kernel")


def test_lost_kernel_records_are_seen():
    assert trace.summarise(events(lose_one=True), wall_s=1e-4, calls=2).records_lost


@pytest.mark.parametrize("name,bare", [
    ("void ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
     "ncclDevKernel_AllReduce_Sum_f32_RING_LL"),
    ("field_rays_fwd_kernel", "field_rays_fwd_kernel"),
    ("void wgrad_tc_kernel<64>(bf16 const*)", "wgrad_tc_kernel"),
    ("void (anonymous namespace)::field_bwd_tc_kernel<true>(Coord, float const*)",
     "field_bwd_tc_kernel"),
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4>(float*)",
     "at::native::cunn_SoftMaxForward")])
def test_bare_name(name, bare):
    assert trace.bare_name(name) == bare
