"""``field_rays_fwd_roofline.train``: kernel 1 (``field_rays``, the MLP over
a ray batch's samples) in a training step, the least time for its work over
its device time in the trace. The work is the coarse (B, N_COARSE) and fine
(B, N_FINE) calls of each step, B the rays of a rank: the forward's
(``counts.field_rays_fwd_work``) and, for the backward that follows, each
sample's residuals written once (``RESIDUAL_BYTES``). The device time is
that of the kernels its source launches (the product kernel and the bf16
weights' packing), by name; a step's other calls of these kernels (a
backward that packs its own weights) count with it."""

# A sample's residuals: each layer's input in bf16, unpadded (the point
# encoding 60, the eight trunk outputs 8 x 256, the direction encoding 24,
# the feature layer's output 256, the view layer's 128), and sigma's sign
# (a float32).
RESIDUAL_BYTES = 2 * (60 + 8 * 256 + 24 + 256 + 128) + 4

NAMES = ("field_rays_fwd_kernel", "pack_kernel", "wnorm_kernel")


def work(counts, rays: int, samples: int):
    flops, nbytes = counts.field_rays_fwd_work(rays, samples)
    return flops, nbytes + RESIDUAL_BYTES * rays * samples


def read(run):
    if run.kind != "train" or run.field != "mlp" or run.peak is None:
        return None
    seconds = max(s.kernels_named(NAMES) for s in run.spans)
    if seconds <= 0.0:
        return None
    c, ini = run.counts, run.ini
    rays = ini["BATCH_RAY"] // run.traffic["ranks"]
    bound = sum(c.bound_s(work(c, rays, n), run.peak)
                for n in (ini["N_COARSE"], ini["N_FINE"]))
    return 100.0 * bound * run.calls / seconds
