"""Multi-device execution (port of ``rustradio_tpu/parallel``): mesh
construction, halo exchange, the sharded ops, the blocks' mesh segments
(``graph_mesh``: ``shard_chain`` in one shot, ``MeshSegment`` streamed by
``Graph.run`` / ``Graph.run_stream(mesh=)``), the stage pipeline
(``pipeline_run``, ``pipeline_run_rates``, ``pipeline_chain``) and the
polyphase channelizer.

The reference's only inter-worker transport is an mmap'd SPSC ring buffer
plus TCP (SURVEY §2.7).  Here the *time axis* of a stream is sharded over
a :class:`Mesh` of devices (several shards may share one device), and
filter history becomes a left-halo exchange between neighbouring shards:
a peer or device-local copy, and ``torch.distributed`` point-to-point
between processes.  ``make_mesh_2d`` builds a (chan, time) mesh: every
function that takes a mesh takes one of its axis names and runs on each
line of the mesh along that axis, replicated along the other.
"""

from .channelizer import (
    channelizer_fm_bank,
    channelizer_taps,
    pfb_channelize,
    pfb_channelize_power,
    sharded_channelizer_fm,
)
from .halo import halo_exchange_left, halo_exchange_right
from .mesh import (
    Mesh,
    init_distributed,
    make_mesh,
    make_mesh_2d,
    time_axis_spec,
)
from .pipeline import pipeline_chain, pipeline_run, pipeline_run_rates
from .sharded import (
    sharded_bell202_demod,
    sharded_fft_filter,
    sharded_fir_filter,
    sharded_fm_demod,
    sharded_quadrature_demod,
    sharded_symbol_sync_bank,
)

__all__ = [
    "Mesh",
    "channelizer_fm_bank",
    "channelizer_taps",
    "halo_exchange_left",
    "halo_exchange_right",
    "init_distributed",
    "make_mesh",
    "make_mesh_2d",
    "pfb_channelize",
    "pfb_channelize_power",
    "pipeline_chain",
    "pipeline_run",
    "pipeline_run_rates",
    "sharded_bell202_demod",
    "sharded_channelizer_fm",
    "sharded_fft_filter",
    "sharded_fir_filter",
    "sharded_fm_demod",
    "sharded_quadrature_demod",
    "sharded_symbol_sync_bank",
    "time_axis_spec",
]
