"""tinynerf_torch — the tinynerf NeRF framework in PyTorch, for one NVIDIA H100.

A second package beside the JAX one (``tinynerf``), which it mirrors module
by module and against which ``tests/test_torch_*.py`` hold it. It imports
neither JAX nor ``tinynerf``. The reference-semantics NeRF is ported: it
trains (``python -m tinynerf_torch --mode train``) and renders from a
checkpoint (``--mode display|path``); ``--mode all`` does both. The field
runs through hand-written CUDA kernels on the card, its forward and its
recompute backward (``kernels/mlp_kernel.py``, ``csrc/field_rays_fwd.cu``,
``csrc/field_rays_bwd.cu``), and through their plain PyTorch versions on the
CPU.
"""

__version__ = "0.1.0"

from tinynerf_torch.config import Config, load_config  # noqa: F401
