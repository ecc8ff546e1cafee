"""``device_idle_pct.render``: the share of the traced frames' window in
which no kernel, copy or fill ran on the card."""


def read(run):
    if run.kind != "render":
        return None
    return max(s.idle_pct for s in run.spans)
