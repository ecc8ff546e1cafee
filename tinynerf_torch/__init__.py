"""tinynerf_torch — the tinynerf NeRF framework in PyTorch, for one NVIDIA H100.

A second package beside the JAX one (``tinynerf``), which it mirrors module
by module and against which ``tests/test_torch_*.py`` hold it. It imports
neither JAX nor ``tinynerf``. The reference-semantics NeRF, the occupancy
grid, bf16, the CP grid field and the proposal grid are ported: it trains
(``python -m tinynerf_torch --mode train``) and renders from a checkpoint
(``--mode display|path``); ``--mode all`` does both. The fields run through
hand-written CUDA kernels on the card (``kernels/mlp_kernel.py``,
``kernels/grid_kernel.py``, ``csrc/*.cu``), and through their plain PyTorch
versions on the CPU.
"""

__version__ = "0.1.0"

from tinynerf_torch.config import Config, load_config  # noqa: F401
