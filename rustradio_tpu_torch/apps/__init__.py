"""CLI applications (port of ``rustradio_tpu/apps``): so far the wideband
channel scanner."""
