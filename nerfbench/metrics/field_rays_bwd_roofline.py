"""``field_rays_bwd_roofline``: kernel 2 (``field_rays_bwd``, the MLP's
backward over a ray batch), the least time for its work over its device
time in the trace. The work (``counts.field_rays_bwd_work``) is the input
and weight gradients of the coarse (B, N_COARSE) and fine (B, N_FINE)
calls of each step, B the rays of a rank, whatever the kernel computes
again; the device time is that of the kernels its source launches, by
name."""

NAMES = ("field_bwd_kernel", "field_bwd_tc_kernel", "wgrad_kernel", "wgrad_tc_kernel",
         "reduce_kernel", "ray_sums_kernel", "transpose_kernel")


def read(run):
    if run.kind != "train" or run.field != "mlp" or run.peak is None:
        return None
    seconds = max(s.kernels_named(NAMES) for s in run.spans)
    if seconds <= 0.0:
        return None
    c, ini = run.counts, run.ini
    rays = ini["BATCH_RAY"] // run.traffic["ranks"]
    bound = sum(c.bound_s(c.field_rays_bwd_work(rays, n), run.peak)
                for n in (ini["N_COARSE"], ini["N_FINE"]))
    return 100.0 * bound * run.calls / seconds
