"""The hand-written CUDA kernels' wrappers (``mlp_kernel``, ``grid_kernel``,
``proposal_kernel``, ``render_kernel``). Each wrapper counts the launches of
its kernel in its ``launches`` attribute; ``wrappers()`` names them all. A
CUDA graph's replay launches the kernels its capture recorded without
calling a wrapper, so the replay adds those counts itself
(``graphs.Captured``)."""

from typing import Callable, Dict


def wrappers() -> Dict[str, Callable]:
    """``{name: wrapper}`` of every kernel wrapper that counts launches."""
    from tinynerf_torch.kernels import grid_kernel as gk
    from tinynerf_torch.kernels import mlp_kernel as mk
    from tinynerf_torch.kernels import proposal_kernel as pk
    from tinynerf_torch.kernels import render_kernel as rk
    return {"field_rays": mk.field_rays, "field_rays_bwd": mk.field_rays_bwd,
            "field_flat": mk.field_flat, "field_flat_bwd": mk.field_flat_bwd,
            "grid_rays": gk.grid_rays, "grid_rays_bwd": gk.grid_rays_bwd,
            "prop_rays": pk.prop_rays, "prop_rays_bwd": pk.prop_rays_bwd,
            "render_fused": rk.render_fused, "render_fused_bwd": rk.render_fused_bwd,
            "merge_bwd": rk.merge_bwd}

