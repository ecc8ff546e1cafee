"""Conf-driven configuration: the same INI keys and defaults as ``tinynerf``.

``conf/<scene>.ini`` holds one section named after the scene. Every key has a
default; ``EPOCH`` is an alias for ``TOTAL_ITER``; ``LR_MILESTONE`` parses as
a list of ints and ``CONTINUE`` as a boolean. This is a copy, kept in step by
``tests/test_torch_slice.py``, so that the port imports nothing of the JAX
package. Keys that select paths the port does not have yet are accepted here
and refused where they would be used (``eval.check_supported``). The port's
own keys (``PORT_KEYS``: ``TRACE_SPANS``) have no counterpart there.
"""

from __future__ import annotations

import configparser
import dataclasses
import os
from typing import List, Optional, Tuple

CONF_DIR = "./conf/"


@dataclasses.dataclass
class Config:
    """Typed run configuration. Field names follow the INI keys."""

    # --- reference keys ---
    gpu: int = 0                      # kept for INI compatibility; unused
    img_dir: str = "./data/lego/"     # scene directory (Blender or LLFF layout)
    results_path: str = "./results/"  # per-view renders, videos
    ckpt_path: str = "./checkpoint/"  # *.npz checkpoints (resume-latest)
    low_res: int = 1                  # image downsample factor
    total_iter: int = 100_000         # training iterations (EPOCH is an alias)
    batch_ray: int = 400              # rays per training step
    learning: float = 3e-4            # Adam learning rate
    lr_gamma: float = 0.1             # decay factor
    lr_milestone: List[int] = dataclasses.field(default_factory=lambda: [10, 200])
    n_coarse: int = 64                # coarse samples per ray
    n_fine: int = 128                 # fine (resampled) samples per ray
    data_type: str = "sync"           # "sync" (Blender) | "llff"
    step: int = 100                   # checkpoint / preview cadence
    decay_end: int = 10_000           # EXP schedule end
    sched: str = "EXP"                # "EXP" | "MULTISTEP"
    continue_: bool = False           # resume from the latest checkpoint

    # --- framework keys (all optional in the INI) ---
    seed: int = 624
    precision: str = "fp32"           # "fp32" | "bf16"
    use_pallas: bool = True           # fused field kernel (the CUDA kernel here)
    fused_render: bool = False        # one-kernel renderer
    compat_sort: bool = False         # reproduce the reference's per-channel sort
    stratified: bool = False          # jittered coarse samples
    ndc: bool = False                 # NDC warp for llff
    contract: bool = False            # mip-360 scene contraction
    lindisp: bool = False             # disparity-linear coarse samples
    near: float = 0.0                 # >0: override every pose row's near
    far: float = 0.0                  # >0: override every pose row's far
    mesh_shape: Optional[int] = None  # data-parallel devices
    sample_shard: int = 0             # >1: shard the fine sample axis
    log_dir: str = "./runs/"
    render_chunk: int = 4096          # rays per render chunk
    pixel_dtype: str = "f32"          # "f32" | "u8" pixel table storage
    host_feed: bool = False           # host-side batch prefetcher
    profile_steps: int = 0            # trace N initial steps
    trace_spans: bool = False         # the port's recorder (profiling.spans_on)
    white_bkgd: bool = False          # white-background compositing term
    val_metrics: bool = False         # held-out val-batch PSNR while training
    proposal: bool = False            # narrow proposal net for the coarse pass
    proposal_width: int = 128
    proposal_depth: int = 4
    proposal_enc_l: int = 10
    prop_pallas: bool = False
    occ_grid: bool = False            # occupancy-grid empty-space skipping
    occ_res: int = 64
    occ_extent: float = 1.5
    occ_thresh: float = 0.01
    occ_update_every: int = 256
    occ_subset: float = 0.125
    occ_march_steps: Optional[int] = None
    occ_march_res: Optional[int] = None
    fine_field: str = "mlp"           # "mlp" | "grid"
    grid_res: int = 256
    grid_levels: int = 1
    grid_comp_density: int = 32
    grid_comp_app: int = 48
    grid_decoder_width: int = 64
    grid_extent: float = 1.5
    grid_lr_mult: float = 20.0
    grid_level_fold: bool = False
    grid_level_lr: float = 1.0
    grid_sigma_width: int = 0
    grid_hybrid: bool = False
    grid_tv: float = 0.0
    dist_loss: float = 0.0
    prop_interlevel: float = 0.0
    grid_upsample: str = ""
    grid_pallas: bool = False
    grid_lookup: str = "onehot"
    prop_field: str = "grid"
    prop_grid_res: int = 64
    prop_grid_comp_density: int = 16
    prop_grid_comp_app: int = 16
    prop_grid_decoder_width: int = 16
    prop_grid_hybrid: bool = False

    @property
    def total_samples(self) -> int:
        return self.n_coarse + self.n_fine


_INT_KEYS = {"GPU", "LOW_RES", "TOTAL_ITER", "EPOCH", "BATCH_RAY", "N_COARSE",
             "N_FINE", "STEP", "DECAY_END", "SEED", "RENDER_CHUNK",
             "PROFILE_STEPS", "OCC_RES", "OCC_UPDATE_EVERY",
             "OCC_MARCH_STEPS", "OCC_MARCH_RES",
             "PROPOSAL_WIDTH", "PROPOSAL_DEPTH",
             "PROPOSAL_ENC_L", "SAMPLE_SHARD", "GRID_RES", "GRID_LEVELS",
             "GRID_COMP_DENSITY", "GRID_COMP_APP", "GRID_DECODER_WIDTH",
             "PROP_GRID_RES", "PROP_GRID_COMP_DENSITY",
             "PROP_GRID_COMP_APP", "PROP_GRID_DECODER_WIDTH",
             "GRID_SIGMA_WIDTH"}
_FLOAT_KEYS = {"LEARNING", "LR_GAMMA", "OCC_EXTENT", "OCC_THRESH",
               "OCC_SUBSET", "GRID_EXTENT", "GRID_LR_MULT", "GRID_LEVEL_LR",
               "GRID_TV", "DIST_LOSS", "PROP_INTERLEVEL", "NEAR", "FAR"}
_BOOL_KEYS = {"CONTINUE", "USE_PALLAS", "COMPAT_SORT", "STRATIFIED", "NDC",
              "HOST_FEED", "WHITE_BKGD", "OCC_GRID", "FUSED_RENDER",
              "PROPOSAL", "PROP_PALLAS", "VAL_METRICS", "CONTRACT",
              "LINDISP", "GRID_HYBRID", "PROP_GRID_HYBRID",
              "GRID_LEVEL_FOLD", "GRID_PALLAS", "TRACE_SPANS"}
# the port's keys, which the JAX package's config does not have
PORT_KEYS = ("TRACE_SPANS",)
_KEY_TO_FIELD = {
    "GPU": "gpu", "IMG_DIR": "img_dir", "RESULTS_PATH": "results_path",
    "CKPT_PATH": "ckpt_path", "LOW_RES": "low_res", "TOTAL_ITER": "total_iter",
    "EPOCH": "total_iter",
    "BATCH_RAY": "batch_ray", "LEARNING": "learning", "LR_GAMMA": "lr_gamma",
    "LR_MILESTONE": "lr_milestone", "N_COARSE": "n_coarse", "N_FINE": "n_fine",
    "DATA_TYPE": "data_type", "STEP": "step", "DECAY_END": "decay_end",
    "SCHED": "sched", "CONTINUE": "continue_",
    "SEED": "seed", "PRECISION": "precision", "USE_PALLAS": "use_pallas",
    "FUSED_RENDER": "fused_render",
    "COMPAT_SORT": "compat_sort", "STRATIFIED": "stratified", "NDC": "ndc",
    "CONTRACT": "contract", "LINDISP": "lindisp",
    "NEAR": "near", "FAR": "far",
    "MESH_SHAPE": "mesh_shape", "LOG_DIR": "log_dir",
    "RENDER_CHUNK": "render_chunk",
    "PIXEL_DTYPE": "pixel_dtype", "HOST_FEED": "host_feed",
    "PROFILE_STEPS": "profile_steps", "TRACE_SPANS": "trace_spans",
    "WHITE_BKGD": "white_bkgd",
    "VAL_METRICS": "val_metrics",
    "OCC_GRID": "occ_grid", "OCC_RES": "occ_res", "OCC_EXTENT": "occ_extent",
    "OCC_THRESH": "occ_thresh", "OCC_UPDATE_EVERY": "occ_update_every",
    "OCC_SUBSET": "occ_subset", "OCC_MARCH_STEPS": "occ_march_steps",
    "OCC_MARCH_RES": "occ_march_res",
    "PROPOSAL": "proposal", "PROPOSAL_WIDTH": "proposal_width",
    "PROPOSAL_DEPTH": "proposal_depth", "PROPOSAL_ENC_L": "proposal_enc_l",
    "PROP_PALLAS": "prop_pallas",
    "SAMPLE_SHARD": "sample_shard",
    "FINE_FIELD": "fine_field", "GRID_RES": "grid_res",
    "GRID_LEVELS": "grid_levels",
    "GRID_COMP_DENSITY": "grid_comp_density", "GRID_COMP_APP": "grid_comp_app",
    "GRID_DECODER_WIDTH": "grid_decoder_width", "GRID_EXTENT": "grid_extent",
    "GRID_LR_MULT": "grid_lr_mult", "GRID_LEVEL_LR": "grid_level_lr",
    "GRID_LEVEL_FOLD": "grid_level_fold",
    "GRID_TV": "grid_tv",
    "GRID_LOOKUP": "grid_lookup", "GRID_PALLAS": "grid_pallas",
    "GRID_HYBRID": "grid_hybrid", "GRID_SIGMA_WIDTH": "grid_sigma_width",
    "GRID_UPSAMPLE": "grid_upsample", "DIST_LOSS": "dist_loss",
    "PROP_INTERLEVEL": "prop_interlevel",
    "PROP_FIELD": "prop_field", "PROP_GRID_RES": "prop_grid_res",
    "PROP_GRID_COMP_DENSITY": "prop_grid_comp_density",
    "PROP_GRID_COMP_APP": "prop_grid_comp_app",
    "PROP_GRID_DECODER_WIDTH": "prop_grid_decoder_width",
    "PROP_GRID_HYBRID": "prop_grid_hybrid",
}


def parse_grid_upsample(spec: str) -> List[Tuple[int, int]]:
    """``GRID_UPSAMPLE`` -> sorted ``[(iter, res), ...]``: comma-separated
    ``iter:res`` pairs (``;`` also separates), e.g. ``"2000:384,4000:512"``.
    Iterations must be distinct and resolutions strictly increasing (an
    upsampling schedule); ``ValueError`` otherwise, as the JAX package's."""
    spec = spec.strip()
    if not spec:
        return []
    pairs = []
    for tok in spec.replace(";", ",").split(","):
        tok = tok.strip()
        if not tok:
            continue
        it_s, _, res_s = tok.partition(":")
        try:
            pairs.append((int(it_s), int(res_s)))
        except ValueError:
            raise ValueError(f"GRID_UPSAMPLE entry {tok!r} is not 'iter:res'") from None
    pairs.sort()
    for (i0, r0), (i1, r1) in zip(pairs, pairs[1:]):
        if i0 == i1 or r1 <= r0:
            raise ValueError("GRID_UPSAMPLE iterations must be distinct and resolutions "
                             f"strictly increasing, got {pairs}")
    return pairs


def _parse_milestones(raw: str) -> List[int]:
    raw = raw.strip().strip("[]")
    if not raw:
        return []
    return [int(tok) for tok in raw.replace(",", " ").split()]


def apply_key(cfg: Config, key: str, raw: str) -> None:
    """Apply one INI-style ``KEY=raw`` override to ``cfg`` in place. Unknown
    keys raise, since a typo in an override would run the wrong config."""
    key = key.upper()
    field = _KEY_TO_FIELD.get(key)
    if field is None:
        raise KeyError(f"unknown config key {key!r}")
    if key == "LR_MILESTONE":
        value = _parse_milestones(raw)
    elif key == "MESH_SHAPE":
        value = None if raw.strip().lower() in ("", "none", "auto") else int(raw)
    elif key in _INT_KEYS:
        value = int(raw)
    elif key in _FLOAT_KEYS:
        value = float(raw)
    elif key in _BOOL_KEYS:
        value = raw.strip().lower() in ("1", "true", "yes", "on")
    else:
        value = raw
    setattr(cfg, field, value)


def load_config(name_or_path: str, conf_dir: str = CONF_DIR) -> Config:
    """Load ``conf/<name>.ini`` (or an explicit path) into a :class:`Config`.

    The section consulted is the scene name; if absent, the file's single
    section is used. Unknown keys are ignored; missing keys keep defaults.
    """
    if os.path.isfile(name_or_path):
        path = name_or_path
        name = os.path.splitext(os.path.basename(path))[0]
    else:
        name = name_or_path
        path = os.path.join(conf_dir, name + ".ini")
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no config file at {path}")

    parser = configparser.ConfigParser()
    parser.read(path)
    if parser.has_section(name):
        section = parser[name]
    elif parser.sections():
        section = parser[parser.sections()[0]]
    else:
        raise ValueError(f"{path} contains no sections")

    cfg = Config()
    # EPOCH is only a fallback for TOTAL_ITER, never an override.
    items = {k.upper(): v for k, v in section.items()}
    if "TOTAL_ITER" in items:
        items.pop("EPOCH", None)
    for key, raw in items.items():
        if key not in _KEY_TO_FIELD:
            continue
        apply_key(cfg, key, raw)
    return cfg
