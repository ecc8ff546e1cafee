"""``device_idle_pct.train``: the share of the traced steps' window in
which no kernel, copy or fill ran on the card (one minus the union of
their intervals); over several cards, the idlest."""


def read(run):
    if run.kind != "train":
        return None
    return max(s.idle_pct for s in run.spans)
