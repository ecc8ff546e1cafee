"""``frame_graph_nodes``: the graph nodes a frame launches, as the program
counted them at its capture (``graph.nodes.frame`` among the counters of
``tinynerf_torch.profiling.snapshot()``: the frame graph's nodes, the
device stopwatch's marks left out, times its replays a view). The render
cell runs its frames in this process, so the counter is this process's. A
program that keeps no such counter reads nothing."""


def read(run):
    if run.kind != "render":
        return None
    from tinynerf_torch import profiling
    snapshot = getattr(profiling, "snapshot", None)
    if snapshot is None:
        return None
    nodes = snapshot().get("counters", {}).get("graph.nodes.frame")
    return None if nodes is None else float(nodes)
