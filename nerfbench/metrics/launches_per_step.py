"""``launches_per_step``: the host's calls that queue work on the card
(kernel and graph launches, asynchronous copies and fills, from the
profiler's CUDA API events) a traced step; over several ranks, the
most."""


def read(run):
    if run.kind != "train":
        return None
    return max(s.launches for s in run.spans) / run.calls
