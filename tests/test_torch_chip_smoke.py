"""Rehearsals of ``chip_smoke.py``'s phases 3-17 on the CPU at small sizes:
every step of a phase (the paths, the apps on files, the checks against
the model calls, float64 and the plain versions) runs on the kernels'
plain versions, so a broken step shows here before a chip run is spent on
it.  What only the card has is stood in for: the launch requirements (no
kernel launches here).
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
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
                          sim_samples=1 << 15, scan_samples=1 << 15)
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
    sizes = cs.ScanSizes(chunk=4096, chunks=9, scans=(9, 4), ax_chunk=1 << 14,
                         ax_scan=4, frames=2, frame_gate=2, block_chunk=1024,
                         tone_n=1 << 14, fm_seconds=0.25)
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
    # feeder and the dashboard; the launch checks need the card
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
                         iir_growing=1 << 12, rds_n=1 << 15, clients=4, feed_c32=1 << 14, feed_u8=1 << 14,
                         feed_chunk=1 << 12, ui_fft=1024)
    counts, errs = cs.live_phase(cpu, "cpu rehearsal", sizes, phase, i_main, q_main)
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for ph in ("14 rtl_data_stream", "14 cma", "14 iir", "14 rtl_data_stream app",
               "14 feeder", "14 ui"):
        assert f"[{ph}] passed" in out
    assert errs == {"cma": 0.0, "iir": 0.0, "fir_decimate": 0.0}
    assert set(counts) == {"rtl_data_stream", "cma", "iir"}
    assert "bit-equal False" not in out and out.count("bit-equal True") == 13


def test_torch_chip_smoke_apps_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phase 10 at small sizes on the plain versions: the FM apps on a 2^16
    # capture, the AX.25 receiver built from blocks offline, streamed and
    # resumed from a checkpoint, and the streamed calls held again
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import hdlc

    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    sizes = cs.AppsSizes(frames=3, frame_gate=3, stream_chunk=1 << 13,
                         resume_after=3)
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
                          burst_chunk=1 << 13)
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
    # the exact launch counts need the card
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import hdlc

    cs = _chip_smoke(monkeypatch)
    sizes = cs.MeshSizes(shards=8, bank_ch=8, bank_n=512, bank_events=56,
                         channels=32, chan_n=1 << 12, frames=2, frame_gate=2)
    cpu = torch.device("cpu")
    audio = torch.from_numpy(cs.audio_corpus(hdlc, sizes.frames))
    want = cs.decoded(ax25.ax25_1200_rx(audio, cs.FS_AUDIO), sizes.frames)
    i_main, q_main, _ = cs.rtl_fm_iq(1 << 16, cpu, torch.Generator().manual_seed(0))
    counts, errs = cs.mesh_phase(cpu, "cpu rehearsal", sizes, i_main, q_main,
                                 audio, want)
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("15 mesh fm", "15 bank", "15 ax25", "15 dryrun"):
        assert f"[{phase}] passed" in out
    assert errs == {"fir_decimate": 0.0, "symbol_sync_scan": 0.0,
                    "symbol_sync_events": 0.0}
    assert "dryrun_multichip(8): OK" in out
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
                               fm_chunks=5, fm_scan=4)
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


def test_torch_chip_smoke_mesh2d_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phase 17 at small sizes on a 2 x 2 mesh on the CPU, the plain
    # versions: every path's replica lines and its 1-D mesh of the axis's
    # size bit-equal, the FM chain and the banks against the offline ops,
    # the corpus streamed (its ragged last chunk demoted once) and decoded;
    # the exact launch counts need the card
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import hdlc

    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    sizes = cs.Mesh2dSizes(bank_ch=8, bank_n=512, bank_events=56, channels=32,
                           chan_n=1 << 12, chunk=1 << 13, frames=2, frame_gate=2)
    cpu = torch.device("cpu")
    audio = torch.from_numpy(cs.audio_corpus(hdlc, sizes.frames))
    assert audio.shape[0] % sizes.chunk % 2  # a ragged last chunk
    want = cs.decoded(ax25.ax25_1200_rx(audio, cs.FS_AUDIO), sizes.frames)
    i_main, q_main, _ = cs.rtl_fm_iq(1 << 16, cpu, torch.Generator().manual_seed(0))
    counts, errs = cs.mesh2d_phase(cpu, "cpu rehearsal", sizes, i_main, q_main,
                                   audio, want)
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("17 mesh2d one shot", "17 mesh2d streamed"):
        assert f"[{phase}] passed" in out
    assert errs == {"fir_decimate": 0.0, "symbol_sync_scan": 0.0,
                    "symbol_sync_events": 0.0}
    assert "2/2 decoded, the offline receiver's list: True" in out
    assert out.count("all lines bit-equal: True") == 6
    assert out.count("bit-equal to the 1-D mesh of 2 shards: True") == 6
    assert {"sharded_fm_demod", "sharded_channelizer_fm", "sharded_symbol_sync_bank scan",
            "sharded_symbol_sync_bank events", "ax25 front-end streamed",
            "ax25_1200_rx_graph"} == set(counts)


# ---- phases 3-9 (CoreSizes), on the plain versions

def _capture(cs, n, fir_n=1 << 14):
    """The main capture and what kernels_phase returns of it, at n samples."""
    from rustradio_tpu_torch import taps as tapgen
    from rustradio_tpu_torch.models import fm

    gen = torch.Generator().manual_seed(0)
    lpr = np.real(tapgen.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0,
                                          "hamming")).astype(np.float32)
    i_main, q_main, phase = cs.rtl_fm_iq(n, torch.device("cpu"), gen)
    packed = {p: fm.fm_pack_planes(i_main, q_main, precision=p)[:2]
              for p in ("w3", "i8")}
    return dict(lpr=lpr, lp1205=tapgen.low_pass(1_024_000.0, 100_000.0, 2048.0),
                xg=torch.randn(fir_n, generator=gen), i_main=i_main, q_main=q_main,
                phase=phase, packed=packed, xc=torch.complex(i_main, q_main))


def test_torch_chip_smoke_kernels_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phases 3 and 3e: kernels A, B and C against the plain versions (here
    # both sides), B against the float64 model, the chained windows and the
    # register-blocked core's edge cases at their own counts
    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    sizes = cs.CoreSizes(fir_n=1 << 14, main_n=1 << 20, prefix=1 << 12, wide=0,
                         edge_ns=(1, 1023 * 4, 1025 * 4 + 1))
    errs, cap = cs.kernels_phase(torch.device("cpu"), "cpu rehearsal", sizes,
                                 torch.Generator().manual_seed(0))
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("3", "3 edges"):
        assert f"[{phase}] passed" in out
    assert errs == {"fir_decimate": 0.0, "fm_chain": 0.0, "quad_demod": 0.0}
    assert "fm_chain flat w3 n=2^20" in out and "every start residue (144 cases)" in out
    assert cap["i_main"].shape == (1 << 20,) and set(cap["packed"]) == {"w3", "i8"}


def test_torch_chip_smoke_fm_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phases 4 and 5: the FM models on the capture, the Graph device loop
    # (eager here) at five offsets, two of them past 2^31, and against the
    # plain versions; the launch checks need the card
    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    sizes = cs.CoreSizes(fir_n=1 << 14, loop_n=1 << 19, chunks=2)
    launches = cs.fm_phase(torch.device("cpu"), "cpu rehearsal", sizes,
                           torch.Generator().manual_seed(1), _capture(cs, 1 << 16))
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("4", "5"):
        assert f"[{phase}] passed" in out
    assert out.count("CUDA-graph replay == eager loop") == 5
    assert set(launches) >= {"fir_decimate", "fm_chain"}


def test_torch_chip_smoke_ax25_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phase 6: the receiver on a few corpus frames and on an IQ capture,
    # kernels (here the plain versions) and plain versions decoding the same
    # list, each FIR stage held
    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    sizes = cs.CoreSizes(frames=3, frame_gate=3, tones_gate=2, iq_frames=1,
                         iq_floor=1)
    audio, iq_np, got, ax_counts, iq_counts = cs.ax25_phase(
        torch.device("cpu"), "cpu rehearsal", sizes)
    out = capsys.readouterr().out
    assert cs.failures == [], out
    assert "[6] passed" in out and out.count("vs plain: max_abs_err") == 7
    assert len(set(got)) == 3 and iq_np.dtype == np.complex64
    assert audio.shape[0] > 0 and "fir_decimate" in ax_counts | iq_counts


def test_torch_chip_smoke_op_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phase 7: the discriminator op on the capture against the transmitted
    # frequency
    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    counts = cs.op_phase(torch.device("cpu"), "cpu rehearsal", _capture(cs, 1 << 16))
    out = capsys.readouterr().out
    assert cs.failures == [], out
    assert "[7] passed" in out and "quad_demod_fast n=2^16" in out
    assert "quad_demod" in counts


def rehearse_sync_phase(monkeypatch, capsys, methods, stations):
    """chip_smoke's phase 9 at a small bank, one sync edge case, a sample of
    kernel E's jump check, a wideband capture of one frame a station, the
    wideband receiver with each sync method of ``methods`` and the
    channelizer at 2^14 samples; returns the module, the phase's results
    and its output."""
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import hdlc

    cs = _chip_smoke(monkeypatch)
    monkeypatch.setattr(cs, "require", lambda *a: None)
    sizes = cs.CoreSizes(frames=1, frame_gate=1, bank_ch=4, bank_n=1 << 10,
                         bank_events=111, sync_prefix=1 << 8, sync_window=64,
                         edge_cases=("taps1",), jump_binades=2, jump_step=1 << 12,
                         wb_stations=stations, wb_frames=1, wb_floor=len(stations),
                         wb_methods=methods, pfb_n=1 << 14, pfb_cell_n=1 << 14)
    audio = torch.from_numpy(cs.audio_corpus(hdlc, sizes.frames))
    got = cs.decoded(ax25.ax25_1200_rx(audio, cs.FS_AUDIO), sizes.frames)
    res = cs.sync_phase(torch.device("cpu"), "cpu rehearsal", sizes,
                        torch.Generator().manual_seed(2), audio, got)
    out = capsys.readouterr().out
    assert cs.failures == [], out
    for phase in ("9 sync", "9 edges", "9 ax25 events", "9 wideband",
                  "9 channelizer"):
        assert f"[{phase}] passed" in out
    return cs, res, out


def test_torch_chip_smoke_sync_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    # phase 9: kernels D and E on the bank against the plain versions and
    # native, the events receiver on the corpus, the wideband receiver with
    # the events sync (kernel E's plain loop costs ~0.6 s a call on a 32 kHz
    # channel here: both syncs in test_torch_chip_smoke_slow.py), and kernel
    # H against its plain version at the bench's and the cell's channels
    cs, (errs, ev_got, ev_counts, wb_counts), out = rehearse_sync_phase(
        monkeypatch, capsys, ("events",), (38,))
    assert errs == {"symbol_sync_events": 0.0, "symbol_sync_scan": 0.0,
                    "pfb_channelize": 0.0}
    assert len(set(ev_got)) == 1 and set(wb_counts) == {"events"}
    for m in (256, 128):
        assert (f"[9 channelizer] kernel H pfb_channelize {m} x 2^14 vs plain: "
                "channels max_abs_err=0.000e+00") in out
    assert "1/1 frames on their channels" in out
