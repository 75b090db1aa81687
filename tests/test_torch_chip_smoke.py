"""A rehearsal of ``chip_smoke.py``'s phase 12 (the radio-facing receivers)
on the CPU at small sizes: every step of the phase (the apps on files, the
simulated SDR, the IL2P capture and blocks, the checks against the model
calls and the plain versions) runs on the kernels' plain versions, so a
broken step shows here before a chip run is spent on it.  The launch
requirements need the card and are left out (no kernel launches here).
"""

import importlib.util
import sys
from pathlib import Path

import torch
# The Graph's cost probe (FlopCounterMode) imports torch._dynamo at its
# first use in a process, ~2 s once: imported with this module, so that
# each test's time is its own.
import torch._dynamo  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", mod)  # for its dataclass
    spec.loader.exec_module(mod)
    return mod


def test_torch_chip_smoke_radio_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    from rustradio_tpu_torch.ops import hdlc

    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    sizes = cs.RadioSizes(frames=2, frame_gate=2, iq_frames=1, iq_gate=1,
                          bell_lines=2, il2p_frames=2, il2p_chunk=300, il2p_gap=200,
                          sim_samples=1 << 15, scan_samples=1 << 15, reps=1)
    counts, errs = cs.radio_phase(torch.device("cpu"), "cpu rehearsal", sizes,
                                  cs.audio_corpus(hdlc, sizes.frames),
                                  cs.iq_capture(hdlc, sizes.iq_frames))
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("12 ax25 au", "12 ax25 iq and bell202", "12 il2p", "12 sdr"):
        assert f"[{phase}] passed" in out
    # the plain versions on both sides of every hold
    assert errs == {"fir_decimate": 0.0, "symbol_sync_events": 0.0,
                    "symbol_sync_scan": 0.0}
    assert set(counts) >= {"ax25_1200_rx au native", "ax25_1200_rx au events",
                           "ax25_1200_rx c32", "ax25_1200_rx SigMF", "bell202_tx",
                           "il2p_1200_rx", "il2p_1200_rx app", "rtl_fm sim",
                           "soapy_fm sim", "scanner sim", "scanner sim decode"}


def test_torch_chip_smoke_scan_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phase 13 at small sizes, the CUDA-graph capture stood in for (each
    # replay runs the recorded function), so that its capture bookkeeping
    # runs here too; the checks of launches and replays need the card
    import rustradio_tpu_torch.graph as graph_mod
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import hdlc

    class Record:
        counts: dict = {}

    class Replayed:
        def __init__(self, fn):
            self.fn, self.record = fn, Record()

        def replay(self):
            return self.fn()

    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    monkeypatch.setattr(graph_mod, "_can_capture", lambda device: True)
    monkeypatch.setattr(graph_mod, "_warm_up", lambda device, fn: (fn(), Record()))
    monkeypatch.setattr(graph_mod, "_capture", lambda device, fn: Replayed(fn))
    sizes = cs.ScanSizes(chunk=4096, chunks=9, scans=(9, 4), reps=1,
                         ax_chunk=1 << 14, ax_scan=4, frames=2, frame_gate=2,
                         block_chunk=1024, tone_n=1 << 14, fm_seconds=0.25,
                         app_reps=1)
    cpu = torch.device("cpu")
    audio = cs.audio_corpus(hdlc, sizes.frames)
    want = {s: cs.decoded(ax25.ax25_1200_rx_graph(audio, cs.FS_AUDIO,
                                                  chunk_size=sizes.ax_chunk,
                                                  sync=s, device="cpu"), sizes.frames)
            for s in ("native", "events")}
    i_main, q_main, _ = cs.rtl_fm_iq(1 << 16, cpu, torch.Generator().manual_seed(0))
    counts, errs = cs.scan_phase(cpu, "cpu rehearsal", sizes, i_main, q_main,
                                 audio, want)
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("13 fm stream", "13 ax25 graph", "13 blocks", "13 generators"):
        assert f"[{phase}] passed" in out
    assert "the trace held no device events" in out and "GFLOP" in out
    assert errs == {"fm_chain": 0.0, "fir_decimate": 0.0,
                    "symbol_sync_events": 0.0}
    assert {"tone", "fm_tx", "spectrum", "morse_beacon", "pw_tone",
            "fm chain device scan_chunks=4"} <= set(counts)


def test_torch_chip_smoke_live_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phase 14 at small sizes on the kernels' plain versions: the CMA and
    # IIR checks, rtl_data_stream (the app's own process included), the
    # feeder and the dashboard; the launch checks and the times need the card
    import numpy as np

    from rustradio_tpu_torch.apps import rtl_data_stream as rds

    class AppInProcess:
        """Stands in for the app's own process (a second interpreter and
        torch import, ~3 s here; tests/test_torch_live_feed.py runs the real
        one): the app's body, ``downsample_u8`` and ``serve_stdio``, on the
        same files."""

        returncode = 0

        def __init__(self, module, args, stdin, stdout):
            assert module == "rustradio_tpu_torch.apps.rtl_data_stream"
            raw = np.fromfile(args[args.index("-r") + 1], np.uint8)
            rds.serve_stdio(rds.downsample_u8(raw, 250e3, 50e3, device="cpu"),
                            stdin, stdout)

        def communicate(self, timeout=None):
            return b"", b""

    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    monkeypatch.setattr(cs, "start_app", AppInProcess)
    cpu = torch.device("cpu")
    i_main, q_main, phase = cs.rtl_fm_iq(1 << 18, cpu, torch.Generator().manual_seed(0))
    sizes = cs.LiveSizes(cma_n=1 << 10, cma_chunk=300, window=128, iir_n=1 << 11,
                         rds_n=1 << 15, clients=4, feed_c32=1 << 14, feed_u8=1 << 14,
                         feed_chunk=1 << 12, ui_fft=1024, reps=1)
    counts, errs, times = cs.live_phase(cpu, "cpu rehearsal", sizes, phase, i_main,
                                        q_main)
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for ph in ("14 rtl_data_stream", "14 cma", "14 iir", "14 rtl_data_stream app",
               "14 times", "14 feeder", "14 ui"):
        assert f"[{ph}] passed" in out
    assert errs == {"cma": 0.0, "iir": 0.0, "fir_decimate": 0.0}
    assert set(counts) == {"rtl_data_stream", "cma", "iir"} and times == {}
    assert "bit-equal False" not in out and out.count("bit-equal True") == 7


def test_torch_chip_smoke_apps_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phase 10 at small sizes on the plain versions: the FM apps on a 2^16
    # capture, the AX.25 receiver built from blocks offline, streamed and
    # resumed from a checkpoint, and the streamed calls held again
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import hdlc

    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    sizes = cs.AppsSizes(frames=3, frame_gate=3, stream_chunk=1 << 13,
                         resume_after=3, reps=1)
    cpu = torch.device("cpu")
    audio = torch.from_numpy(cs.audio_corpus(hdlc, sizes.frames))
    want = {s: cs.decoded(ax25.ax25_1200_rx(audio, cs.FS_AUDIO, sync=s), sizes.frames)
            for s in ("native", "events")}
    i_main, q_main, _ = cs.rtl_fm_iq(1 << 16, cpu, torch.Generator().manual_seed(0))
    counts, errs = cs.apps_phase(cpu, "cpu rehearsal", sizes, i_main, q_main, audio,
                                 want)
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("10 apps", "10 ax25 graph"):
        assert f"[{phase}] passed" in out
    assert errs == {"fir_decimate": 0.0, "symbol_sync_events": 0.0}
    assert {"rtl_fm c32", "rtl_fm w3", "rtl_fm i8", "wbfm_rx", "am_decode",
            "graph events resumed"} <= set(counts)


def test_torch_chip_smoke_burst_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phase 11 at a few frames on the plain versions: the G3RUH modem, the
    # burst receivers, the WPCR corpus' first bursts, the packet apps on the
    # captures as files, and the block-built front half paused in a burst
    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    sizes = cs.BurstSizes(frames=1, gate=1, wpcr_bursts=4, wpcr_gate=2,
                          burst_chunk=1 << 13, reps=1)
    counts, errs = cs.burst_phase(torch.device("cpu"), "cpu rehearsal", sizes)
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("11 receivers", "11 wpcr", "11 apps", "11 block graph"):
        assert f"[{phase}] passed" in out
    assert errs == {"fir_decimate": 0.0, "symbol_sync_events": 0.0}
    assert {"g3ruh_modulate", "ax25_9600_rx native", "ax25_9600_rx events",
            "wpcr_batch", "app burst_saver"} <= set(counts)


def test_torch_chip_smoke_mesh_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phase 15 at small sizes on 8 shards on the CPU, the plain versions:
    # the sharded FM ops against the offline ops, the channel-sharded banks,
    # the AX.25 front-end sharded with the native tail, and the dry run;
    # the exact launch counts and the times need the card
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import hdlc

    cs = _chip_smoke(monkeypatch)
    sizes = cs.MeshSizes(shards=8, bank_ch=8, bank_n=512, bank_events=56,
                         channels=32, chan_n=1 << 12, frames=2, frame_gate=2)
    cpu = torch.device("cpu")
    audio = torch.from_numpy(cs.audio_corpus(hdlc, sizes.frames))
    want = cs.decoded(ax25.ax25_1200_rx(audio, cs.FS_AUDIO), sizes.frames)
    i_main, q_main, _ = cs.rtl_fm_iq(1 << 16, cpu, torch.Generator().manual_seed(0))
    counts, errs, times = cs.mesh_phase(cpu, "cpu rehearsal", sizes, i_main, q_main,
                                        audio, want)
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("15 mesh fm", "15 bank", "15 ax25", "15 dryrun"):
        assert f"[{phase}] passed" in out
    assert errs == {"fir_decimate": 0.0, "symbol_sync_scan": 0.0,
                    "symbol_sync_events": 0.0}
    assert times == {} and "dryrun_multichip(8): OK" in out
    assert {"sharded_fm_demod", "sharded_fir_filter", "sharded_fft_filter",
            "sharded_quadrature_demod", "sharded_symbol_sync_bank scan",
            "sharded_symbol_sync_bank events", "sharded_channelizer_fm",
            "sharded_bell202_demod"} <= set(counts)


def test_torch_chip_smoke_mesh_stream_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phase 16 at small sizes on 8 shards on the CPU, the plain versions:
    # the corpus through ax25_1200_rx_graph on the mesh (both syncs, per
    # chunk, batched, across a checkpoint; the ragged last chunk demoted
    # once), the holds, and the FM chain streamed on the mesh; the exact
    # launch counts and the bit equality with shard_chain need the card
    from rustradio_tpu_torch.ops import hdlc

    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    sizes = cs.MeshStreamSizes(shards=8, chunk=1 << 13, scan=3, resume_after=2,
                               frames=2, frame_gate=2, fm_chunk=1 << 12,
                               fm_chunks=5, fm_scan=4, reps=1)
    audio = torch.from_numpy(cs.audio_corpus(hdlc, sizes.frames))
    assert audio.shape[0] % sizes.chunk % 8  # a ragged last chunk
    counts, errs = cs.mesh_stream_phase(torch.device("cpu"), "cpu rehearsal",
                                        sizes, audio)
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("16 mesh ax25", "16 mesh fm"):
        assert f"[{phase}] passed" in out
    assert errs == {"fir_decimate": 0.0, "symbol_sync_events": 0.0}
    assert "the front-end demoted at chunks [" in out and "fm mesh batched" in set(counts)
