"""metaasr_tpu_torch — the PyTorch/CUDA port of ``metaasr_tpu``.

The JAX package stays the reference; this package mirrors its module paths
(``frontend/fbank.py``, ``models/transformer.py``, ``decode/beam_search.py``,
``serve/export.py`` ...) so each piece has an obvious counterpart. It
imports ``torch`` and never ``jax`` or ``metaasr_tpu``.

Every Pallas kernel of the reference becomes a kernel written by hand for
Hopper (``csrc/``), built with ``nvcc`` at first use and bound with ctypes
(``ops/_build.py``). Entry points run on CUDA unless the caller passes
``device="cpu"``; on a CPU tensor a kernel wrapper runs its plain PyTorch
version, on a CUDA tensor it launches the kernel or raises.
"""

__version__ = "0.1.0"

from metaasr_tpu_torch.config import Config, load_config, save_config  # noqa: E402

__all__ = ["Config", "load_config", "save_config", "__version__"]
