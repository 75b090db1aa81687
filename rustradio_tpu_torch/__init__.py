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

from . import blocks, convert, dtypes, lowering, models, ops, taps, windows
from .dtypes import Complex, Float, parse_frequency, parse_verbosity
from .graph import CancellationToken, Graph
from .streams import Pdu, StreamValue, Tag

__version__ = "0.1.0"

__all__ = [
    "CancellationToken",
    "Complex",
    "Float",
    "Graph",
    "Pdu",
    "StreamValue",
    "Tag",
    "blocks",
    "convert",
    "dtypes",
    "lowering",
    "models",
    "ops",
    "parse_frequency",
    "parse_verbosity",
    "taps",
    "windows",
]
