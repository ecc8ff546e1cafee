"""``mfu.train``: the step's share of the cards' bf16 peak. The model
operations of the traced steps (``counts.train_step_flops``: each field
evaluation's forward products, by the configuration's own
``forward_flops_per_ray``, times 3; and its ``refresh_flops`` for each
occupancy refresh among them), over the traced span's host-clock seconds,
the cards and the peak (``peaks.json``). A configuration without those
counts reads nothing."""


def read(run):
    model = run.model
    if (run.kind != "train" or run.peak is None
            or not hasattr(model, "forward_flops_per_ray") or not hasattr(model, "refresh_flops")):
        return None
    flops = (run.counts.train_step_flops(model, run.ini, run.ini["BATCH_RAY"]) * run.calls
             + model.refresh_flops(run.ini) * run.refreshes)
    wall = max(s.wall_s for s in run.spans)
    return 100.0 * flops / (wall * run.chips * run.peak["bf16_flops_per_s"])
