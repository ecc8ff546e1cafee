"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
same configuration keys, traffic and limits, with fewer rays, samples,
views and pixels (the MLP keeps its widths, which the program fixes).
``tiny_ranks_cell`` is the training cell as one job of four ranks, the
kept ``train_dp4`` traffic, which no cell of the file uses yet."""

import dataclasses

from nerfbench import harness

TINY_INI = {"BATCH_RAY": 64, "N_COARSE": 8, "N_FINE": 8, "OCC_RES": 16, "RENDER_CHUNK": 256}
TINY_SCENE = {"views": 4, "height": 16, "width": 16}


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    ini = {k: TINY_INI.get(k, v) for k, v in cell.ini.items()}
    traffic = dict(cell.traffic, scene=dict(cell.traffic["scene"], **TINY_SCENE),
                   trace_steps=2, trace_frames=1, path_views=6, stop_check_steps=2)
    return dataclasses.replace(cell, config=dict(cell.config, ini=ini), traffic=traffic)


def tiny_ranks_cell() -> harness.Cell:
    cell = tiny_cell("train-lego_occ")
    traffic = harness.load_json(f"{harness.BENCH_DIR}/traffic/train_dp4.json")
    traffic = dict(traffic, scene=dict(traffic["scene"], **TINY_SCENE), trace_steps=2,
                   stop_check_steps=2)
    return dataclasses.replace(cell, name="train-lego_occ-dp4", chips=4, traffic=traffic,
                               limits=dict(cell.limits, rank_mismatch=0))
