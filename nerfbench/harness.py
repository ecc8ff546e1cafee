"""What the harness reads by name: a cell of ``BENCHMARK.json``, its
configuration (``configs/<config>.json`` and its plain reference
``configs/<config>.py``, which holds its operation counts), its traffic mix
(``traffic/<traffic>.json``, whose ``kind`` names the module that runs it,
``cells/<kind>.py``), its limits (``limits/<cell>.json``) and the readers
of its per-layer metrics (``metrics/<metric>.py``). A cell or metric added later brings its own
files and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
# the top-level modules no process of a run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "tinynerf")
# keys of a configuration file's ``ini`` that name places, not the model
PLACE_KEYS = ("IMG_DIR", "RESULTS_PATH", "CKPT_PATH", "LOG_DIR", "GPU")


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A Python file of the benchmark, by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def sub_seed(seed: int, k: int) -> int:
    """The ``k``-th stream drawn from a run's ``--seed``: a non-negative
    integer under 2**63, for any whole ``seed``."""
    return (int(seed) * 1_000_003 + k) % (1 << 63)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict          # configs/<config>.json
    traffic: dict         # traffic/<traffic>.json
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def ini(self) -> dict:
        return self.config["ini"]

    @property
    def reference_path(self) -> str:
        return os.path.join(BENCH_DIR, "configs", self.config_name + ".py")

    def reference(self):
        return load_module(self.reference_path, f"nerfbench_ref_{self.config_name}")


def _applies(metric: dict, cell: str, moves_ok=None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moves_ok is None or moves_ok(metric)


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_json(BENCHMARK)
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _applies(m, name, lambda m: m["moves"] in e2e_names)]
    return Cell(name=name, chips=w["chips"], config_name=w["config"],
                config=load_json(os.path.join(BENCH_DIR, "configs", w["config"] + ".json")),
                traffic=load_json(os.path.join(BENCH_DIR, "traffic", w["traffic"] + ".json")),
                limits=load_json(os.path.join(BENCH_DIR, "limits", name + ".json")),
                end_to_end=e2e, per_layer=layer)


def metric_reader(name: str):
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"),
                       "nerfbench_metric_" + name.replace(".", "_"))


def program_config(ini: dict, seed: int, ranks: int = 1):
    """The program's ``Config`` of a configuration file's ``ini`` keys, each
    given to the program's own parser as the INI would give it."""
    from tinynerf_torch.config import _KEY_TO_FIELD, Config, apply_key
    cfg = Config()
    for key, value in ini.items():
        if key in PLACE_KEYS:
            continue
        if isinstance(value, bool):
            raw = "true" if value else "false"
        elif isinstance(value, list):
            raw = "[" + ", ".join(str(v) for v in value) + "]"
        else:
            raw = str(value)
        apply_key(cfg, key, raw)
        got = getattr(cfg, _KEY_TO_FIELD[key])
        if isinstance(value, (bool, int, float)) and (type(got) is not type(value)
                                                      or got != value):
            raise ValueError(f"the program reads {key} = {raw} as {got!r}")
    cfg.seed = sub_seed(seed, 9) % (1 << 31)
    if ranks > 1:
        apply_key(cfg, "MESH_SHAPE", str(ranks))
    return cfg


def start(device: str, patch: Optional[str] = None):
    """A run's device, the card as a ``torch.device`` with its index and
    its peak memory reset; first ``patch`` (``module:function``, a test's
    planted fault) is called."""
    import torch
    from tinynerf_torch.device import resolve_device
    if patch:
        module_name, _, fn = patch.partition(":")
        getattr(importlib.import_module(module_name), fn)()
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)
    return dev


def forbidden_modules() -> List[str]:
    """The forbidden top-level modules this process holds, compared by whole
    top-level name (``tinynerf_torch`` is not ``tinynerf``)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)
