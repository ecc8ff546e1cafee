"""``mfu.render``: a frame's share of the card's bf16 peak. The forward
products of every pixel's samples (``counts.frame_flops``, by the
configuration's own ``forward_flops_per_ray``) times the traced frames,
over the traced span's host-clock seconds and the peak. A configuration
without that count reads nothing."""


def read(run):
    model = run.model
    if run.kind != "render" or run.peak is None or not hasattr(model, "forward_flops_per_ray"):
        return None
    scene = run.traffic["scene"]
    flops = run.counts.frame_flops(model, run.ini, scene["height"] * scene["width"])
    wall = max(s.wall_s for s in run.spans)
    return 100.0 * flops * run.calls / (wall * run.peak["bf16_flops_per_s"])
