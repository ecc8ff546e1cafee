"""``field_rays_fwd_roofline``: kernel 1 (``field_rays``, the MLP over a
ray batch's samples) in a frame, the least time for its work over its
device time in the trace. The work (``counts.field_rays_fwd_work``) is
every pixel's N_COARSE and N_FINE samples, the padding of the last chunk
not counted; the device time is that of the kernels its source launches
(the product kernel and the bf16 weights' packing), by name."""

NAMES = ("field_rays_fwd_kernel", "pack_kernel", "wnorm_kernel")


def read(run):
    if run.kind != "render" or run.field != "mlp" or run.peak is None:
        return None
    seconds = max(s.kernels_named(NAMES) for s in run.spans)
    if seconds <= 0.0:
        return None
    c, ini, scene = run.counts, run.ini, run.traffic["scene"]
    pixels = scene["height"] * scene["width"]
    bound = sum(c.bound_s(c.field_rays_fwd_work(pixels, n), run.peak)
                for n in (ini["N_COARSE"], ini["N_FINE"]))
    return 100.0 * bound * run.calls / seconds
