"""``allreduce_ms_per_step``: NCCL's all-reduce kernels' device time a
traced step (the gradient's, with the loss), on the rank where it is
longest, its wait for the other ranks included."""


def read(run):
    if run.kind != "train" or run.chips < 2:
        return None
    seconds = max(s.kernels_containing("AllReduce") for s in run.spans)
    return 1e3 * seconds / run.calls if seconds > 0.0 else None
