"""rustradio_tpu_torch — the FM receive chain of rustradio_tpu on PyTorch,
with hand-written CUDA kernels for Hopper (H100).

The JAX package ``rustradio_tpu`` is the reference; this package mirrors
its module layout and public names (``ops``, ``blocks``, ``models``,
``graph``, ``lowering``) and imports neither jax nor ``rustradio_tpu``.
Ops run on their inputs' device; sources and the device loop take an
explicit ``device``.  The kernels (``csrc/*.cu``) are built by nvcc at
first use on a CUDA tensor; on CPU tensors every kernel wrapper runs its
plain PyTorch version.
"""

from . import blocks, convert, lowering, models, ops, taps, windows
from .graph import Graph
from .streams import Tag

__all__ = [
    "Graph",
    "Tag",
    "blocks",
    "convert",
    "lowering",
    "models",
    "ops",
    "taps",
    "windows",
]
