#!/usr/bin/env python3
"""Smoke test of rustradio_tpu_torch on one NVIDIA GPU.

Builds the port's CUDA kernels from this checkout, holds each kernel
against its plain PyTorch version on the card, and drives its paths at
full width, each with the launch counts set to 0 just before it and read
just after, so that each shows it went through its kernels:

* the FM receive chain (the models entry points and the Graph device loop
  over a packed ring): kernels A and B;
* the AX.25 1200 bd receiver on the 1000-frame decode-rate corpus at
  24 kHz (``ax25_1200_rx``, >= 980 decoded, on the kernels and on the
  plain versions), and on a narrowband-FM IQ capture at 1.024 Msps
  (``ax25_1200_rx_iq``), with each FIR stage of the receiver held
  against its plain version at both rates: kernel A;
* the standalone discriminator op (``ops.quad_demod_fast``): kernel C;
* the clock recovery: kernels D (event-driven) and E (per-sample) held
  against their plain versions (and E against native ``rr_symbol_sync``)
  at bench.py's decode-bank shape, the AX.25 receiver with
  ``sync="events"`` on the corpus, and the wideband multichannel receiver
  (``decode_band_ax25``, 64 channels of a 2.048 Msps capture carrying 8
  stations) with both sync methods: kernels A, D and E, each held again
  against its plain version (E also against native) on the arguments
  that these paths gave it;
* the FM family's apps at 2^24 samples: ``rtl_fm`` on the main path's
  capture written as c32 (kernel A) and as rtl-sdr u8 (kernel B, w3 and
  i8), ``am_decode`` on an AM capture and ``wbfm_rx`` on the station
  (kernel A), each .au or audio held against the same call on the plain
  versions and its tones against the modulating ones; and the AX.25
  receiver built from blocks (``ax25_1200_rx_graph``) on the corpus, both
  sync methods, offline and through ``Graph.run_stream``, and a streamed
  run paused at a checkpoint and resumed: kernels A and D;
* the G3RUH modem and the burst receivers on 200 corpus frames each:
  ``g3ruh_modulate`` (kernel A, the 723-tap channel filter at 300 kHz);
  ``ax25_9600_rx`` on one 300 kHz G3RUH stream with both sync methods
  (kernel D); ``ax25_9600_wpcr_rx`` on 300 kHz G3RUH bursts and
  ``ax25_1200_wpcr_rx`` on 50 kHz AFSK bursts (kernel A at 1205 taps),
  each >= 196 decoded and the plain versions' list; ``wpcr_batch`` on the
  JAX package's WPCR corpus (>= 100, every burst's bin and symbols equal
  to the CPU run's and to ``wpcr_numpy``); the apps ``ax25_9600_rx``,
  ``ax25_1200_wpcr``, ``ax25_9600_wpcr``, ``g3ruh`` (RX to KISS, TX from
  KISS) and ``burst_saver`` on the captures as files; and the 9600 WPCR
  front half built from blocks, offline, streamed in chunks of 2^16 and
  paused at a checkpoint inside a burst and resumed;
* the radio-facing receivers (``radio_phase``, phase 12): the apps
  ``ax25_1200_rx`` on the corpus as .au (both clock recoveries) and on the
  IQ capture as raw c32 and as SigMF written by ``capture``, each the
  model call's list; ``bell202_tx`` into ``ax25_1200_rx`` at 44.1 kHz; a
  50 kHz capture of 200 IL2P frames through ``il2p_1200_rx`` (model, plain
  versions, app) and its bits through ``CorrelateAccessCodeTag`` and
  ``Il2pDeframer``, offline and streamed with headers across chunk seams;
  ``rtl_fm -r sim`` and ``soapy_fm -d sim`` at 2^24 samples and
  ``scanner -r sim`` on the simulated SDR (``hw/``): kernels A, D and E,
  each held against its plain version on the apps' own calls;
* the batched streaming runner (``scan_phase``, phase 13): the FM chain
  (kernel B) over 64 chunks of 2^20 of an ``rtl_fm_iq`` capture through
  ``Graph.run_stream`` per chunk and with ``scan_chunks`` 64 and 24, to a
  ``VectorSink`` and device-resident (``emit_batch`` / ``accept_batch``):
  each batch one CUDA-graph replay, kernel B once a chunk, the output
  bit-equal to the per-chunk card run and within kernel B's budget of the
  plain versions, a traced run (``profile_dir``) and
  ``generate_stats()``; ``ax25_1200_rx_graph`` on the corpus
  with ``scan_chunks=16``, both syncs (kernel A on the segment's outputs,
  kernel D on its calls); every capturable block class alone over three
  batches; and the generator apps ``tone``, ``fm_tx`` into ``rtl_fm``,
  ``spectrum``, ``morse_beacon`` and ``pw_tone`` at full width;
* the recurrences and the live feeds (``live_phase``, phase 14): kernel F
  (``ops.cma_equalize`` and the ``CmaEqualizer`` block streamed in chunks
  of 2^18) on 2^22 samples of the main path's station at unit modulus
  through a pre-echo channel, kernel G (``ops.iir_filter`` at orders 2 and
  8) on 2^24 samples of noise, F bit-equal to its plain version on its
  first 2^14 outputs and on a second call over the last 2^14 windows from
  the first call's taps (with its final taps), G over the whole stream
  (its plain version as torch ops on the card) and its first chunk to the
  sequential form, the equalizer's output streamed, and the split call,
  within 1e-5 of max|y| of one call (F's blocks of windows count from
  each call's start; the streamed gap printed over 2^18, 2^20 and 2^22
  windows), the one call within 1e-5 of a float64 model over 2^14
  windows and of the sequential f32 recurrence over 2^18 (numpy on the
  host), its modulus dispersion at most half the input's,
  the IIR outputs within 5e-6 of a float64 model;
  ``rtl_data_stream`` on 2^24 samples of an FM station at 250 kHz
  (``downsample_u8`` with kernel A held on its calls and within one LSB
  of the plain versions' bytes, the app's stdin/stdout protocol in a
  process of its own, 4 concurrent TCP clients);
  ``DeviceFeeder`` on a 512 MiB c32 and a 128 MiB u8iq file (every chunk
  exact); and
  ``ui_server``'s ``SpectrumFeed`` and ``UiServer`` on the main capture
  (rows within 0.1 dB of a float64 spectrogram, the peak at the station,
  one HTTP and one websocket fetch);
* the multi-device layer, one shot (``mesh_phase``, phase 15): a mesh of
  four shards on the card (``make_mesh(4, device="cuda:0")``): the
  sharded FM chain (kernel A once a shard), ``sharded_fir_filter`` and
  ``sharded_fft_filter`` at 49 taps / deci 4 and
  ``sharded_quadrature_demod`` on the main capture against their offline
  ops; the decode bank with its channels sharded (kernels E and D once a
  shard), bit-equal to the unsharded call; the 256-channel
  ``sharded_channelizer_fm`` against ``channelizer_fm_bank``; the AX.25
  front-end sharded over the corpus with the native tail, the offline
  receiver's list; and ``tools.dryrun.dryrun_multichip(4)``;
* the multi-device layer, streamed (``mesh_stream_phase``, phase 16), 4
  shards on the card: the AX.25 corpus through ``ax25_1200_rx_graph(mesh=,
  chunk_size=2**18)`` with both syncs, per chunk and with
  ``scan_chunks=16``, and 20 + 35 chunks around a checkpoint, each the
  unsharded graph's list (>= 980), the ragged last chunk demoted once and
  no other, kernel A and D held on the events run's own calls; phase 13's
  FM chain streamed on the mesh per chunk and batched, bit-equal to
  ``shard_chain`` over the whole stream and within kernel B's budget of
  the unsharded stream;
* 2-D meshes (``mesh2d_phase``, phase 17): ``make_mesh_2d(2, 2)`` on the
  card at phases 15-16's widths: the sharded FM chain over ``time``, the
  channelizer and the decode bank (both syncs) over ``chan``, the corpus
  streamed through the front-end and ``ax25_1200_rx_graph(mesh=)`` over
  ``time`` (the offline list, demoted once at the ragged end); each path
  counted, its replica lines and its 1-D mesh of the axis's size
  bit-equal, kernels A, D and E held on its calls.

Kernels A and B are also held against their plain versions where their
register-blocked design can break (every start residue of the 16-byte
load grid, spans past both ends of a plane, counts around a tile, tap
counts around the register block, large decimations), and the Graph
device loop's CUDA-graph replay against its eager loop (bit-equal folds
at four offsets, two of them a chunk under and over 2^31).  Kernels D and
E are held bit for bit against their plain versions on the edge inputs of
``rustradio_tpu_torch/tools/sync_cases.py``
(sizes around their tiles, misaligned rows, silence, chatter, crossings on
a tile's edges, 2.5 to 100 samples per symbol, 1 to 16 clock taps, cut
streams), and kernel H against its plain version at the benchmark's
256 x 2^22 and the wideband cell's 128 x 2^28.

It times nothing: a kernel's time alone comes from
``tools/bench_kernels.py``, a cell's from radiobench (``BENCHMARK.json``).

    python3 chip_smoke.py        # from the repository root, one GPU

Exits non-zero, printing no result line, when there is no CUDA device or
any phase fails.  The line before the last is the kernels' JSON record;
the last line is {"ok": true, "device": {...}}.  Phases 3 to 17 are
functions of (device, card, sizes, ...) and rehearse on the CPU at small
sizes on the plain versions, what only the card has stood in for
(``CoreSizes`` for phases 3-9: ``kernels_phase``, ``fm_phase``,
``ax25_phase``, ``op_phase``, ``sync_phase``; then ``AppsSizes``,
``BurstSizes``, ``RadioSizes``, ``ScanSizes``, ``LiveSizes``,
``MeshSizes``, ``MeshStreamSizes``, ``Mesh2dSizes``;
tests/test_torch_chip_smoke.py).  The shared inputs and float64 models
are the package's (``tools/corpus.py``), imported here under their names.
Phases 1-2 (the environment, the build) need the card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import torch

# the decode bank's shape (bench.py:223-232), the shared inputs and
# float64 models, and the plain-version switch, from the package
from rustradio_tpu_torch.tools.corpus import (  # noqa: F401
    BANK_CH, BANK_EVENTS, BANK_N, BANK_NOISE, BANK_SPS, CMA_MU, CMA_TAPS,
    CMA_TOL, IIR_TAPS, IIR_TOL, cma_channel, cma_sequential, decode_bank,
    fm_chain_f64, iir_f64, rtl_fm_iq)
from rustradio_tpu_torch.tools.timing import plain_versions, sync  # noqa: F401

DECI = 4
N_MAIN = 1 << 24          # samples per plane on the main path
N_FIR = 1 << 22           # samples for the fir_decimate checks
N_PREFIX = 1 << 18        # prefix held against the float64 model
RING = 4 * N_MAIN         # the Graph's packed ring
N_CHUNKS = 8              # device-loop chunks of N_MAIN (two ring passes)
# the JAX package's own budgets against float64 (tests/test_pallas_interpret.py)
BUDGET = {"highest": 2e-4, "w3": 3e-4, "i8": 3e-4, "w2": 8e-3}
GAIN_C = 0.7              # kernel C's gain, as tests/test_pallas_interpret.py:62
FS_AUDIO = 24_000.0       # the decode-rate corpus (tests/test_decode_rate.py)
N_FRAMES = 1000
FRAME_GATE = 980          # the JAX package's gate on that corpus
TONES_GATE = 900
FS_IQ = 1_024_000.0       # rtl-sdr's rate (apps/rtl_fm.py)
IQ_DEV = 3_000.0          # narrowband FM deviation, Hz
IQ_NOISE = 0.3            # receiver noise per I/Q component; carrier 1.0
N_IQ_FRAMES = 200         # corpus frames carried on the IQ capture
IQ_FLOOR = 196            # of them decoded by ax25_1200_rx_iq
N_SYNC_PREFIX = 1 << 12   # kernel E against its plain per-sample loop
N_SYNC_WINDOW = 2048      # samples (E) or crossings (D) per window held
                          # against the plain loops at a path's own shapes
FS_WB = 2_048_000.0       # the wideband capture: an rtl-sdr rate,
WB_CHANNELS = 64          # 64 channels of 32 kHz (sps 26.7),
WB_STATIONS = (3, 9, 17, 26, 38, 45, 53, 60)  # 8 stations, 4 above M/2,
WB_FRAMES = 25            # 25 corpus frames each (200 frames),
WB_DEV = 3_000.0          # FM at 3 kHz deviation,
WB_NOISE = 0.05           # complex noise per component
WB_FLOOR = 196            # frames of 200 decoded per sync method
PFB_CH, N_PFB = 256, 1 << 22  # bench.py's channelizer row (bench.py:194-209)
CELL_CH, N_CELL = 128, 1 << 28  # the wideband cell's channelizer (aprs_wideband.scan)
# kernel H against its plain version: the widest gap of the channels over
# their RMS (each lies within 2e-5 of it from the float64 reference, so
# the two within twice that of each other) and of the power, relative
PFB_TOL, PFB_POWER_TOL = 4e-5, 1e-5


def jump_mismatches(device, binades: int = 21, step: int = 1,
                    runs: int = 64) -> int:
    """Kernel E's jump between events (csrc/sync_core.cuh, ScanWalker's
    positions), checked exhaustively: for every f32 position in [1,
    2^binades) (every ``step``-th mantissa; 1: all) and every run of 1 to
    ``runs`` samples up to the walker's limit, 3 top + ceil(top - position)
    - 1 (top: the power of two above the position; the sums cross at most
    two powers of two), position + run in one addition against run
    additions of 1, each rounded.  Returns the number of pairs that
    differ."""
    bad = torch.zeros((), dtype=torch.int64, device=device)
    mantissas = torch.arange(0, 1 << 23, step, dtype=torch.int32, device=device)
    for e in range(binades):
        base = (mantissas + ((127 + e) << 23)).view(torch.float32)
        top = 2.0 ** (e + 1)
        lim = 3.0 * top + torch.ceil(top - base) - 1.0
        chain = base.clone()
        for run in range(1, runs + 1):
            chain += 1.0
            single = base + float(run)
            bad += ((run <= lim) & (single != chain)).sum()
    return int(bad)


# outputs from which the FIR core's launcher takes its widest shape (two
# blocks of 1024 outputs per SM)
WIDE = 264 * 1024
SEED = 0
DEVICE = "cuda"

failures: list[str] = []


def report(phase: str, what: str, err: float, tol: float) -> float:
    ok = err <= tol
    print(f"[{phase}] {what}: max_abs_err={err:.3e} tol={tol:.3e} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{phase} {what}")
    return err


def end_phase(phase: str) -> None:
    if failures:
        raise SystemExit(f"chip_smoke: phase {phase} failed: {failures}")
    print(f"[{phase}] passed")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    if a.shape != b.shape:
        failures.append(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        return math.inf
    return float((a.double() - b.double()).abs().max())


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _kernels():
    from rustradio_tpu_torch.ops import kernels
    return kernels


def zero_counts():
    kernels = _kernels()
    for k in kernels.LAUNCHES:
        kernels.LAUNCHES[k] = 0


def require(path: str, counts: dict, names) -> None:
    """A failure for each kernel of ``names`` that ``counts`` shows never
    launched on ``path``."""
    for name in names:
        if counts[name] == 0:
            failures.append(f"kernel {name} never launched on the "
                            f"{path} path")


@contextlib.contextmanager
def capturing(*names):
    """Record the arguments of every call of the wrappers
    ``kernels.<name>`` inside the block (the main path's own shapes);
    the calls still go to the wrappers and count their launches."""
    kernels = _kernels()
    got = {name: [] for name in names}
    with contextlib.ExitStack() as stack:
        for name in names:
            real = getattr(kernels, name)
            stack.enter_context(mock.patch.object(
                kernels, name, lambda *a, real=real, calls=got[name]:
                calls.append(a) or real(*a)))
        yield got


def wrapped_err(a: torch.Tensor, b: torch.Tensor, gain: float) -> float:
    """max |a - b| folded into [-pi|g|, pi|g|): a +-pi branch flip of the
    angle counts as no error."""
    if a.shape != b.shape:
        failures.append(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
        return math.inf
    g = abs(gain)
    d = torch.remainder(a.double() - b.double() + math.pi * g, 2 * math.pi * g)
    return float((d - math.pi * g).abs().max())


# ---- the AX.25 corpus, built as tests/test_decode_rate.py:23-55 builds it

def corpus_payload(i: int) -> bytes:
    return f"N0CALL-{i%16}>APRS:T#{i:04d} corpus {'y'*(i%29)}".encode()


def corpus_line(i: int, hdlc) -> np.ndarray:
    """Frame i as an NRZI line (transition on 0)."""
    framed = hdlc.hdlc_frame(hdlc.fcs_add(np.frombuffer(corpus_payload(i),
                                                         np.uint8)))
    return (1 + np.cumsum(1 - np.asarray(framed))) % 2


def corpus_drift(i: int) -> float:
    return ((i % 7) - 3) / 3 * 0.015


def afsk(line: np.ndarray, baud: float, amp: float, fs: float,
         lead: int) -> np.ndarray:
    """Bell-202 tones for an NRZI line at ``fs``, between ``lead`` zeros."""
    sps = fs / baud
    n = int(len(line) * sps)
    bit_at = np.minimum((np.arange(n) / sps).astype(int), len(line) - 1)
    freqs = np.where(line[bit_at] == 1, 1200.0, 2200.0)
    a = (amp * np.sin(np.cumsum(2 * np.pi * freqs / fs))).astype(np.float32)
    z = np.zeros(lead, np.float32)
    return np.concatenate([z, a, z])


def audio_corpus(hdlc, n_frames: int = N_FRAMES) -> np.ndarray:
    """The first ``n_frames`` corpus frames (1000) at 24 kHz: amplitude
    0.05-1.0, clock drift
    +-1.5%, noise up to 0.4x amplitude, numpy RandomState(0)."""
    noises = [0.0, 0.15, 0.3, 0.35, 0.4]
    rng = np.random.RandomState(SEED)
    parts = []
    for i in range(n_frames):
        amp = 0.05 + 0.95 * (i % 10) / 9
        x = afsk(corpus_line(i, hdlc), 1200.0 * (1 + corpus_drift(i)), amp,
                 FS_AUDIO, 400)
        parts.append(x + rng.randn(len(x)).astype(np.float32)
                     * (noises[i % 5] * amp))
    return np.concatenate(parts)


def iq_capture(hdlc, n_frames: int = N_IQ_FRAMES) -> np.ndarray:
    """The first ``n_frames`` corpus frames as an rtl-sdr capture: full-scale
    Bell-202 audio frequency-modulates a carrier at IQ_DEV deviation,
    sampled at FS_IQ, plus complex receiver noise (numpy default_rng)."""
    lead = int(400 * FS_IQ / FS_AUDIO)  # the corpus' leads, in time
    chunks, ph0 = [], 0.0
    for i in range(n_frames):
        a = afsk(corpus_line(i, hdlc), 1200.0 * (1 + corpus_drift(i)), 1.0,
                 FS_IQ, lead)
        ph = ph0 + np.cumsum(a, dtype=np.float64) * (2 * np.pi * IQ_DEV / FS_IQ)
        ph0 = float(ph[-1] % (2 * np.pi))
        chunks.append(np.exp(1j * ph).astype(np.complex64))
    iq = np.concatenate(chunks)
    noise = np.random.default_rng(SEED).standard_normal((2, len(iq)),
                                                        dtype=np.float32)
    iq.real += IQ_NOISE * noise[0]
    iq.imag += IQ_NOISE * noise[1]
    return iq


def decoded(packets, n: int) -> list[bytes]:
    """The corpus payloads among the packets, in decode order."""
    want = {corpus_payload(i) for i in range(n)}
    return [bytes(p) for p in packets if bytes(p) in want]


def wideband_capture(hdlc, device, gen: torch.Generator, stations=WB_STATIONS,
                     frames: int = WB_FRAMES) -> torch.Tensor:
    """``frames`` corpus frames per station, station s carrying frames
    s*frames.., each Bell-202 at its corpus clock drift and full scale
    between the corpus' leads, frequency-modulating a carrier at the center
    of channel stations[s] of WB_CHANNELS; summed at FS_WB, plus complex
    noise.  Made on the card (float64 phases)."""
    lead = int(400 * FS_WB / FS_AUDIO)  # the corpus' leads, in time
    z = torch.zeros(lead, dtype=torch.float64, device=device)
    tones = []
    for s in range(len(stations)):
        parts = []
        for i in range(s * frames, (s + 1) * frames):
            line = torch.from_numpy(corpus_line(i, hdlc).astype(np.int64)).to(device)
            sps = FS_WB / (1200.0 * (1 + corpus_drift(i)))
            t = torch.arange(int(len(line) * sps), dtype=torch.float64,
                             device=device)
            bit_at = torch.clamp((t / sps).long(), max=len(line) - 1)
            f = torch.where(line[bit_at] == 1, 1200.0, 2200.0)
            parts += [z, torch.sin(torch.cumsum(2 * math.pi * f / FS_WB, 0)), z]
        tones.append(torch.cat(parts))
    n = max(len(a) for a in tones)
    t = torch.arange(n, dtype=torch.float64, device=device)
    iq = torch.zeros(n, dtype=torch.complex64, device=device)
    for k, a in zip(stations, tones):
        fc = (k if k < WB_CHANNELS / 2 else k - WB_CHANNELS) * FS_WB / WB_CHANNELS
        ph = (torch.cumsum(torch.nn.functional.pad(a, (0, n - len(a))), 0)
              * (2 * math.pi * WB_DEV / FS_WB) + (2 * math.pi * fc / FS_WB) * t)
        iq += torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
    noise = WB_NOISE * torch.randn((2, n), generator=gen, device=device)
    return iq + torch.complex(noise[0], noise[1])


# ---- phases 3-9: the kernels against their plain versions, the FM and
# AX.25 paths, the discriminator op, the clock recovery and the channelizer


@dataclasses.dataclass(frozen=True)
class CoreSizes:
    """Phases 3-9's sizes: the defaults on the card; a CPU rehearsal
    (``tests/test_torch_chip_smoke.py``) takes small ones."""

    fir_n: int = N_FIR            # kernel A's noise
    main_n: int = N_MAIN          # the main path's capture (>= 2^20: two
                                  # fm_chain_window tiles)
    prefix: int = N_PREFIX        # held against the float64 models
    wide: int = WIDE              # the edge cases again, this many outputs more
    edge_ns: tuple = (1, 1023 * 4, 1025 * 4 + 1, (1 << 16) + 3)  # kernel A's
    loop_n: int = N_MAIN          # the Graph device loop's chunk,
    chunks: int = N_CHUNKS        # its chunks (a ring of 4 chunks)
    frames: int = N_FRAMES        # the AX.25 corpus
    frame_gate: int = FRAME_GATE
    tones_gate: int = TONES_GATE
    iq_frames: int = N_IQ_FRAMES  # the IQ capture
    iq_floor: int = IQ_FLOOR
    bank_ch: int = BANK_CH        # the decode bank
    bank_n: int = BANK_N
    bank_events: int = BANK_EVENTS
    sync_prefix: int = N_SYNC_PREFIX
    sync_window: int = N_SYNC_WINDOW
    edge_cases: tuple | None = None  # tools/sync_cases.py's, by name (None: all)
    jump_binades: int = 21        # kernel E's jump check over [1, 2^binades),
    jump_step: int = 1            # every jump_step-th mantissa
    wb_stations: tuple = WB_STATIONS  # the wideband capture
    wb_frames: int = WB_FRAMES
    wb_floor: int = WB_FLOOR
    wb_methods: tuple = ("scan", "events")  # its sync methods
    pfb_n: int = N_PFB            # the channelizer's checks: the bench's shape
    pfb_cell_n: int = N_CELL      # and the wideband cell's


def size_label(n: int) -> str:
    """``2^k`` for a power of two, else the number."""
    return f"2^{n.bit_length() - 1}" if n > 0 and n & (n - 1) == 0 else str(n)


def kernels_phase(dev, card: str, sizes: CoreSizes, gen: torch.Generator):
    """Phases 3 and 3e on ``dev``: kernel A on ``sizes.fir_n`` samples of
    noise (49 taps / deci 4 and 1205 / 1), kernel B on the main capture
    (``rtl_fm_iq`` of ``sizes.main_n`` samples: flat at every precision,
    packed w3 and i8, chained windows) and against the float64 model over
    ``sizes.prefix`` samples, kernel C on the capture as complex64, each
    against its plain version; then kernels A and B where the
    register-blocked core can break, at each case's own count and with
    ``sizes.wide`` outputs more.  Returns the largest |error| of A, B and
    C, and the capture with what later phases reuse: ``lpr``, ``lp1205``,
    ``xg``, ``i_main``, ``q_main``, ``phase``, ``packed`` (the w3 and i8
    planes) and ``xc``."""
    from rustradio_tpu_torch import taps as tapgen
    from rustradio_tpu_torch.models import fm
    from rustradio_tpu_torch.ops import kernels

    # ---- 3. kernels against their plain versions on the card
    lpr = np.real(tapgen.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0,
                                          "hamming")).astype(np.float32)
    lp1205 = tapgen.low_pass(1_024_000.0, 100_000.0, 2048.0)
    if (len(lpr), len(lp1205)) != (49, 1205):
        raise SystemExit(f"chip_smoke: tap sets of {len(lpr)}, {len(lp1205)}")
    errs = {"fir_decimate": 0.0, "fm_chain": 0.0, "quad_demod": 0.0}
    xg = torch.randn(sizes.fir_n, generator=gen, device=dev)
    n_fir, n_main = size_label(sizes.fir_n), size_label(sizes.main_n)
    for taps, deci in [(lpr, 4), (lp1205, 1)]:
        got = kernels.fir_decimate(xg, taps, deci)
        want = kernels.fir_decimate_plain(xg, taps, deci)
        tol = 2e-5 * float(want.abs().max())
        errs["fir_decimate"] = max(errs["fir_decimate"], report(
            "3 kernels", f"fir_decimate {len(taps)} taps deci {deci} n={n_fir} f32",
            max_err(got, want), tol))

    i_main, q_main, phase = rtl_fm_iq(sizes.main_n, dev, gen)
    pre_want = fm_chain_f64(i_main[: sizes.prefix].cpu().numpy(),
                            q_main[: sizes.prefix].cpu().numpy(), lpr)
    n_pre = size_label(sizes.prefix)
    for precision in ("highest", "w3", "i8", "w2"):
        got = kernels.fm_chain(i_main, q_main, lpr, DECI, precision=precision)
        with plain_versions():
            want = kernels.fm_chain(i_main, q_main, lpr, DECI,
                                    precision=precision)
        errs["fm_chain"] = max(errs["fm_chain"], report(
            "3 kernels", f"fm_chain flat {precision} n={n_main}",
            max_err(got, want), BUDGET[precision]))
        report("3 kernels", f"fm_chain flat {precision} vs float64 model, "
               f"{n_pre}-sample prefix",
               float(np.abs(got[: len(pre_want)].cpu().numpy() - pre_want).max()),
               BUDGET[precision])
    packed = {}
    for precision in ("w3", "i8"):
        pr, pi, n = fm.fm_pack_planes(i_main, q_main, precision=precision)
        packed[precision] = (pr, pi)
        got = kernels.fm_chain(pr, pi, lpr, DECI, precision=precision, n=n)
        with plain_versions():
            want = kernels.fm_chain(pr, pi, lpr, DECI, precision=precision, n=n)
        errs["fm_chain"] = max(errs["fm_chain"], report(
            "3 kernels", f"fm_chain packed {precision} n={n_main}",
            max_err(got, want), BUDGET[precision]))
    pr, pi = packed["w3"]
    half = sizes.main_n // DECI // 128 // 1024 // 2  # tiles of 1024 rows per window
    a1, last1 = kernels.fm_chain_window(pr, pi, lpr, DECI, row0=0, g=half)
    a2, last2 = kernels.fm_chain_window(pr, pi, lpr, DECI, row0=half * 1024,
                                        g=half, seed=last1)
    both, last12 = kernels.fm_chain_window(pr, pi, lpr, DECI, row0=0, g=2 * half)
    # identical arithmetic per sample: the chained windows must reproduce
    # the one-call stream bit for bit, up to 1e-6 stated
    report("3 kernels", "fm_chain_window two chained windows == one call",
           max(max_err(torch.cat([a1, a2]), both), max_err(last2, last12)), 1e-6)
    with plain_versions():
        pa1, plast1 = kernels.fm_chain_window(pr, pi, lpr, DECI, row0=0, g=half)
    errs["fm_chain"] = max(errs["fm_chain"], report(
        "3 kernels", "fm_chain_window w3 vs plain (audio, last)",
        max(max_err(a1, pa1), max_err(last1, plast1)), BUDGET["w3"]))
    xc = torch.complex(i_main, q_main)  # the station, complex64
    got_c = kernels.quad_demod_fast(xc, GAIN_C)
    want_c = kernels.quad_demod_fast_plain(xc, GAIN_C)
    # unfused conjugate product in both; the polynomial's FMA contraction
    # moves a few ulps; a +-pi branch flip is no error (wrapped)
    errs["quad_demod"] = report(
        "3 kernels", f"quad_demod gain {GAIN_C} n={n_main} vs plain (wrapped)",
        wrapped_err(got_c, want_c, GAIN_C), 1e-6 * GAIN_C)
    pre = xc[: sizes.prefix].cpu().numpy().astype(np.complex128)
    pre_want = GAIN_C * np.angle(np.conj(pre[:-1]) * pre[1:])
    report("3 kernels", f"quad_demod vs float64 model, {n_pre}-sample prefix "
           "(wrapped)", wrapped_err(got_c[: sizes.prefix - 1].cpu(),
                                    torch.from_numpy(pre_want), GAIN_C),
           2e-4 * GAIN_C)
    del got_c, want_c
    end_phase("3")

    # ---- 3e. kernels A and B where the register-blocked design can break:
    # one line per group, the case nearest its tolerance
    def worst(what: str, cases) -> float:
        cases = list(cases)
        err, tol = max(cases, key=lambda c: c[0] / c[1])
        report("3 edges", f"{what} ({len(cases)} cases)", err, tol)
        return err

    def slow_planes(n: int, ntaps: int, deci: int, precision: str):
        """Wire-grid I/Q planes of an FM signal slow enough to pass a
        unit-gain ``ntaps`` low-pass at full amplitude, and to turn by at
        most 1 rad per output at ``deci``: no angle comes near +-pi, where
        the last bit of the conjugate product picks the branch."""
        d = min(0.9, 2.0 / ntaps, 1.0 / deci)
        t = torch.arange(n, dtype=torch.float64, device=dev)
        ph = torch.cumsum(d * torch.sin(t * (2e-3 * d)), 0)
        out = []
        for f in (torch.cos, torch.sin):
            v = 0.45 * f(ph) + 0.02 * torch.randn(n, generator=gen, device=dev,
                                                  dtype=torch.float64)
            out.append(kernels.plane_cast(
                (torch.round(torch.clamp(v * 128, -127, 128)) / 128).float(),
                precision))
        return out

    def unit_lp(ntaps: int) -> np.ndarray:
        w = np.hamming(ntaps) if ntaps > 1 else np.ones(1)
        return (w / w.sum()).astype(np.float32)

    def span_case(precision, ntaps, deci, first, count, shift, length):
        """(err, tol) of kernel B's audio and of its last filtered sample
        against the plain version on one span."""
        a, b = slow_planes(length, ntaps, deci, precision)
        kw = dict(first=first, count=count, shift=shift, precision=precision,
                  offset=0.01, seed=(0.3, -0.2))
        got, last = kernels.fm_chain_span(a, b, unit_lp(ntaps), deci, 0.9, **kw)
        want, wlast = kernels.fm_chain_span_plain(a, b, unit_lp(ntaps), deci,
                                                  0.9, **kw)
        return [(max_err(got, want), BUDGET[precision]),
                (max_err(last, wlast), 2e-5)]

    # an input this small gets small tiles of 4 outputs a thread from the
    # launcher; from WIDE outputs on it takes its widest shape (8 outputs a
    # thread, tiles of 1024, and for deci 1, 2 and 4 the staging compiled
    # with deci known), the shape of every full-size call: each case runs at
    # its own count and again with WIDE outputs more
    for extra in dict.fromkeys((0, sizes.wide)):
        size = f"+{extra} outputs"
        tap_deci = [(1, 1), (7, 1), (9, 1), (3, 4), (5, 4), (49, 4), (49, 3),
                    (1205, 1), (4096, 1), (4096, 50), (1, 50), (49, 50)]
        errs["fm_chain"] = max(
            errs["fm_chain"],
            worst(f"{size}: fm_chain_span: the span starts at every "
                  "residue of the 16-byte grid (f32, bf16, s8)",
                  (c for prec, v in (("highest", 4), ("w3", 8), ("i8", 16))
                   for r in range(v)
                   for c in span_case(prec, 49, DECI, 3, 2500 + extra, -48 + r,
                                      (1 << 15) + DECI * extra))),
            worst(f"{size}: fm_chain_span: taps 1..4096, deci 1, 3, 4, "
                  "50, spans past both ends of the plane (pad 0, -1 for "
                  "s8)",
                  (c for nt, d in tap_deci for prec in ("w3", "i8")
                   for c in span_case(prec, nt, d, 0, 1500 + extra, 1 - nt,
                                      (1500 + extra) * d + nt - 7))),
            worst(f"{size}: fm_chain_span: counts 1, 2 and around a tile "
                  "of 1024 and 2048",
                  (c for cnt in (1, 2, 1023, 1024, 1025, 2047, 2049)
                   for prec in ("w3", "i8")
                   for c in span_case(prec, 49, DECI, 7, cnt + extra, -48,
                                      (1 << 14) + DECI * extra))),
            worst(f"{size}: fm_chain_span: a window that ends at the "
                  "plane's last sample",
                  (c for prec in ("w3", "i8")
                   for c in span_case(prec, 49, DECI, 4096, 4096 + extra, 0,
                                      (4096 + 4096 + extra - 1) * DECI + 49))))

        def fir_cases():
            for nt, d in [(1, 1), (3, 1), (5, 1), (7, 1), (9, 1), (49, 4), (49, 3),
                          (65, 2), (1205, 1), (4096, 1), (4096, 50), (1, 50)]:
                taps = np.random.RandomState(nt + d).randn(nt).astype(np.float32)
                for n in sizes.edge_ns:
                    n += extra * d
                    base = torch.randn(n + 3, generator=gen, device=dev)
                    for off in range(4):  # every residue of the 16-byte grid
                        x = base[off : off + n]
                        want = kernels.fir_decimate_plain(x, taps, d)
                        yield (max_err(kernels.fir_decimate(x, taps, d), want),
                               2e-5 * max(float(want.abs().max()), 1e-3))

        errs["fir_decimate"] = max(errs["fir_decimate"], worst(
            f"{size}: fir_decimate: taps 1..4096, deci 1..50, 1 to 2^16+3 "
            "samples and up, every start residue", fir_cases()))
    xc_edge = torch.complex(torch.randn((1 << 16) + 5, generator=gen, device=dev),
                            torch.randn((1 << 16) + 5, generator=gen, device=dev))
    before_edge = kernels.LAUNCHES["fir_decimate"]
    both_planes = kernels.fir_decimate(xc_edge, lpr, DECI)
    one_launch = kernels.LAUNCHES["fir_decimate"] - before_edge
    each_plane = torch.complex(
        kernels.fir_decimate(xc_edge.real.contiguous(), lpr, DECI),
        kernels.fir_decimate(xc_edge.imag.contiguous(), lpr, DECI))
    report("3 edges", f"fir_decimate complex input, real taps: {one_launch} "
           "launch, against two 1-plane launches",
           max_err(torch.view_as_real(both_planes),
                   torch.view_as_real(each_plane)), 0.0)
    if dev.type == "cuda" and one_launch != 1:
        failures.append(f"complex input took {one_launch} kernel-A launches")
    null_seed = kernels.fm_chain_span(*packed["w3"], lpr, DECI, first=0,
                                      count=4096, shift=3, precision="w3")
    zero_seed = kernels.fm_chain_span(*packed["w3"], lpr, DECI, first=0,
                                      count=4096, shift=3, precision="w3",
                                      seed=(0.0, 0.0))
    report("3 edges", "fm_chain_span without a seed == with the zero seed",
           max(max_err(null_seed[0], zero_seed[0]),
               max_err(null_seed[1], zero_seed[1])), 0.0)
    del xc_edge, both_planes, each_plane
    end_phase("3 edges")
    return errs, dict(lpr=lpr, lp1205=lp1205, xg=xg, i_main=i_main,
                      q_main=q_main, phase=phase, packed=packed, xc=xc)


def fm_phase(dev, card: str, sizes: CoreSizes, gen: torch.Generator, cap: dict):
    """Phases 4 and 5 on ``dev``: the FM path counted, the models on the
    main capture ``cap`` (``fm_pack_planes`` + ``fm_demod_chain_planar``
    w3 and i8; ``fm_demod_chain`` on its first ``sizes.fir_n`` samples) and
    the Graph device loop (``sizes.chunks`` chunks of ``sizes.loop_n``
    over a packed ring of four chunks, captured into a CUDA graph on the
    card); then the models against the plain versions and the transmitted
    frequency, and the captured loop against the eager loop at five
    offsets and against the plain versions.  Returns the launch counts
    after the loop's first replay."""
    from rustradio_tpu_torch import blocks
    from rustradio_tpu_torch.graph import Graph
    from rustradio_tpu_torch.models import fm
    from rustradio_tpu_torch.ops import kernels

    on_card = dev.type == "cuda"
    lpr, i_main, q_main, phase = (cap[k] for k in ("lpr", "i_main", "q_main", "phase"))
    n_main, chunk, n_chunks = i_main.shape[0], sizes.loop_n, sizes.chunks

    # ---- 4 + 5. the FM path, counted
    zero_counts()
    outs = {}
    for precision in ("w3", "i8"):
        pr, pi, n = fm.fm_pack_planes(i_main, q_main, precision=precision)
        outs[precision] = fm.fm_demod_chain_planar(pr, pi, precision=precision,
                                                   n=n)
    iq = torch.complex(i_main[: sizes.fir_n], q_main[: sizes.fir_n])
    outs["complex"] = fm.fm_demod_chain(iq)
    after_models = dict(kernels.LAUNCHES)

    ring_i, ring_q, _ = rtl_fm_iq(4 * chunk, dev, gen)

    def build_graph(cuda_graph=True):
        g = Graph()
        src = g.add(blocks.PackedIqRingSource(ring_i, ring_q, lpr, DECI,
                                              precision="w3"))
        fir = g.add(blocks.FirFilter(lpr, deci=DECI, precision="w3"), src)
        qd = g.add(blocks.QuadratureDemod(1.0), fir)
        g.add(blocks.DeviceFoldSink(fn=lambda c, x: c + x.sum() + (x * x).sum()),
              qd)
        return g.compile_device_loop(chunk, n_chunks, device=dev,
                                     cuda_graph=cuda_graph)

    # the device loop's first call runs the loop once eagerly (its warm-up,
    # whose launches count apart), captures it into a CUDA graph and
    # replays it; later calls only replay
    loop = build_graph()
    fold_t = next(iter(loop(0).values()))
    fold = float(fold_t)
    launches = dict(kernels.LAUNCHES)
    graph_launches = launches["fm_chain"] - after_models["fm_chain"]
    fold_again = next(iter(loop(0).values()))
    replay_launches = kernels.LAUNCHES["fm_chain"] - launches["fm_chain"]
    print(f"[4+5 main path] launches {json.dumps(launches)}; models "
          f"{json.dumps(after_models)}; graph fm_chain launches "
          f"{graph_launches} for {n_chunks} chunks (first replay; its warm-up "
          f"and capture counted apart), "
          f"{replay_launches} for a replay alone")
    require("FM", launches, ("fir_decimate", "fm_chain"))
    if on_card and (after_models["fir_decimate"] < 1
                    or after_models["fm_chain"] < 2):
        failures.append("the models path launched fewer kernels than it calls")
    if on_card and (graph_launches != n_chunks or replay_launches != n_chunks):
        failures.append(f"graph launched fm_chain {graph_launches} then "
                        f"{replay_launches} times")

    # ---- 4. checks of the models path
    with plain_versions():
        for precision in ("w3", "i8"):
            pr, pi, n = fm.fm_pack_planes(i_main, q_main, precision=precision)
            want = fm.fm_demod_chain_planar(pr, pi, precision=precision, n=n)
            report("4 models", f"fm_pack_planes + fm_demod_chain_planar "
                   f"{precision} n={size_label(n_main)} vs plain",
                   max_err(outs[precision], want), BUDGET[precision])
        want = fm.fm_demod_chain(iq)
    # exact atan2 on the filtered stream: f32 rounding amplified at small
    # filtered samples, the chain budget of tests/test_pallas.py (1e-3 rad)
    report("4 models", f"fm_demod_chain n={size_label(sizes.fir_n)} complex vs "
           "plain", max_err(outs["complex"], want), 1e-3)
    # the demodulated audio is the station's: output k spans input samples
    # 4k-24 .. 4k+4-24 (the 49-tap filter's 24-sample delay)
    out = outs["w3"]
    k = torch.arange(64, out.shape[0] - 64, device=dev)
    truth = phase[DECI * (k + 1) - 24] - phase[DECI * k - 24]
    corr = float(torch.corrcoef(torch.stack([out[k].double(), truth]))[0, 1])
    finite = all(bool(torch.isfinite(o).all()) for o in outs.values())
    print(f"[4 models] w3 audio vs transmitted frequency: corr={corr:.6f} "
          f"finite={finite} shape={tuple(out.shape)}")
    if not (finite and corr > 0.99 and out.shape[0] == n_main // DECI - 1):
        failures.append("models output")
    end_phase("4")

    # ---- 5. the captured loop against the eager loop (bit-equal folds, at
    # two offsets), then against the same graph on the plain versions
    eager_loop = build_graph(cuda_graph=False)
    # (offsets one chunk under and over 2^31 wrap the ring from its last
    # chunk: the captures of other offsets)
    far = [(o, next(iter(loop(o).values())))
           for o in ((1 << 31) - chunk, (1 << 31) + chunk)]
    for offset0, got_fold in [(0, fold_t), (0, fold_again),
                              (2 * chunk, next(iter(loop(2 * chunk).values())))] + far:
        want_fold = next(iter(eager_loop(offset0).values()))
        report("5 graph", f"CUDA-graph replay == eager loop at offset0 "
               f"{offset0} (fold {float(got_fold)!r})",
               max_err(got_fold, want_fold), 0.0)
    with plain_versions():
        plain_loop = build_graph(cuda_graph=False)
        plain_fold = float(next(iter(plain_loop(0).values())))
    rel = abs(fold - plain_fold) / abs(plain_fold)
    print(f"[5 graph] fold={fold!r} plain_fold={plain_fold!r} rel_err={rel:.3e}")
    # f32 folds of 8 x 4M outputs (sum + sum of squares): rtol 1e-4
    if not (math.isfinite(fold) and rel <= 1e-4):
        failures.append("graph fold")
    end_phase("5")
    return launches


def ax25_phase(dev, card: str, sizes: CoreSizes):
    """Phase 6 on ``dev``: the AX.25 1200 bd receiver counted, on the
    corpus of ``sizes.frames`` frames at 24 kHz (on the kernels, with the
    tones demod, and on the plain versions) and on an IQ capture of
    ``sizes.iq_frames`` frames at 1.024 Msps, each FIR stage of the
    receiver held against its plain version at both rates.  Returns the
    corpus (on ``dev``), the IQ capture (numpy), the frames decoded on the
    kernels, and the launch counts of the corpus and IQ paths."""
    from rustradio_tpu_torch import ops, taps as tapgen
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import hdlc, kernels

    def stage_err(what: str, fn, x: torch.Tensor) -> torch.Tensor:
        """``fn(x)`` on the kernels against ``fn(x)`` on the plain versions
        at the FIR budget 2e-5 * max|y|; returns the kernels' output."""
        got = fn(x)
        with plain_versions():
            want = fn(x)
        g, w = (torch.view_as_real(t) if t.is_complex() else t
                for t in (got, want))
        report("6 ax25", f"{what} ({x.shape[0]} samples) vs plain",
               max_err(g, w), 2e-5 * float(w.abs().max()))
        return got

    def front_end_errs(what: str, audio: torch.Tensor, fs: float,
                       tones: bool) -> None:
        """kernel A at the AX.25 receiver's own shapes, on its own data:
        each FIR stage of ``bell202_demod`` (and of the tone demod's
        one-symbol moving average), fed the kernels' input of that stage.
        The stages are held one by one because the exact discriminator
        between them turns a last-ulp difference at a near-zero analytic
        sample into an arbitrary angle."""
        bp = tapgen.band_pass(fs, 400.0, 2700.0, 65, "hamming")
        lp = tapgen.low_pass(fs, 1100.0, 200.0, "hamming")
        x = stage_err(f"{what}: band-pass {len(bp)} taps",
                      lambda a: ops.filter_float(a, bp), audio)
        x = stage_err(f"{what}: Hilbert 65 taps",
                      lambda a: ops.hilbert_transform(a, 65, "hamming"), x)
        stage_err(f"{what}: low-pass {len(lp)} taps",
                  lambda a: ops.filter_float(a, lp),
                  ops.quadrature_demod(x, 1.0))
        if tones:
            w = int(fs / 1200.0)
            avg = np.ones(w, np.float32) / w
            stage_err(f"{what}: tone moving average {w} taps",
                      lambda a: ops.fir_filter_full(a, avg), audio)

    # ---- 6. the AX.25 1200 bd path, counted: the corpus at 24 kHz, then an
    # IQ capture at 1.024 Msps
    n_frames, n_iq = sizes.frames, sizes.iq_frames
    audio = torch.from_numpy(audio_corpus(hdlc, n_frames)).to(dev)
    print(f"[6 ax25] corpus: {n_frames} frames, {audio.shape[0]} samples at "
          f"{FS_AUDIO:.0f} Hz")
    zero_counts()
    got = decoded(ax25.ax25_1200_rx(audio, FS_AUDIO), n_frames)
    ax_counts = dict(kernels.LAUNCHES)
    tones = decoded(ax25.ax25_1200_rx(audio, FS_AUDIO, demod="tones"), n_frames)
    tone_counts = dict(kernels.LAUNCHES)
    with plain_versions():
        plain_got = decoded(ax25.ax25_1200_rx(audio, FS_AUDIO), n_frames)
    print(f"[6 ax25] ax25_1200_rx decoded {len(set(got))}/{n_frames} on the "
          f"kernels, {len(set(plain_got))}/{n_frames} on the "
          f"plain versions; tones {len(set(tones))}/{n_frames}; launches "
          f"{json.dumps(ax_counts)}, with tones {json.dumps(tone_counts)}")
    require("AX.25", ax_counts, ("fir_decimate",))
    front_end_errs("corpus at 24 kHz", audio, FS_AUDIO, tones=True)
    for what, n, gate in (("kernels", got, sizes.frame_gate),
                          ("plain versions", plain_got, sizes.frame_gate),
                          ("tones", tones, sizes.tones_gate)):
        if len(set(n)) < gate:
            failures.append(f"ax25_1200_rx on the {what}: {len(set(n))} < {gate}")

    iq_np = iq_capture(hdlc, n_iq)
    print(f"[6 ax25] IQ capture: {n_iq} frames, {len(iq_np)} samples at "
          f"{FS_IQ:.0f} Hz, {IQ_DEV:.0f} Hz deviation, noise {IQ_NOISE} per "
          f"component")
    zero_counts()
    iq_got = decoded(ax25.ax25_1200_rx_iq(iq_np, FS_IQ, device=dev), n_iq)
    iq_counts = dict(kernels.LAUNCHES)
    with plain_versions():
        iq_plain = decoded(ax25.ax25_1200_rx_iq(iq_np, FS_IQ, device=dev), n_iq)
    print(f"[6 ax25] ax25_1200_rx_iq decoded {len(set(iq_got))}/{n_iq} "
          f"on the kernels, {len(set(iq_plain))}/{n_iq} on the plain versions; "
          f"same list: {iq_got == iq_plain}; launches {json.dumps(iq_counts)}; "
          f"card: {card}")
    require("AX.25 IQ", iq_counts, ("fir_decimate",))
    if iq_got != iq_plain:
        failures.append("ax25_1200_rx_iq: kernels and plain versions decode "
                        "different frames")
    if len(set(iq_got)) < sizes.iq_floor:
        failures.append(f"ax25_1200_rx_iq: {len(set(iq_got))} < {sizes.iq_floor}")
    # the channel filter (FFT route), resampler and discriminator launch no
    # kernel: one IQ front-end output feeds the stages at 50 kHz
    fm_audio = ax25.iq_front_end(iq_np, FS_IQ, device=dev)
    front_end_errs("IQ capture at 50 kHz", fm_audio, 50_000.0, tones=False)
    del fm_audio  # iq_np comes back in phase 12
    end_phase("6")
    return audio, iq_np, got, ax_counts, iq_counts


def op_phase(dev, card: str, cap: dict) -> dict:
    """Phase 7 on ``dev``: the discriminator op (``ops.quad_demod_fast``)
    on the main capture as complex64, counted, against the transmitted
    frequency.  Returns the launch counts."""
    from rustradio_tpu_torch import ops
    from rustradio_tpu_torch.ops import kernels

    xc, phase = cap["xc"], cap["phase"]
    # ---- 7. the discriminator op path, counted
    zero_counts()
    out_c = ops.quad_demod_fast(xc, GAIN_C)
    op_counts = dict(kernels.LAUNCHES)
    require("op", op_counts, ("quad_demod",))
    # per-sample receiver noise caps the raw correlation near 0.96; over the
    # FM chain's 4-sample decimation it is the station's audio
    m = (out_c.shape[0] // DECI) * DECI
    mean4 = (out_c[:m].double() / GAIN_C).reshape(-1, DECI).mean(1)
    truth = (phase[1 : m + 1] - phase[:m]).reshape(-1, DECI).mean(1)
    corr = float(torch.corrcoef(torch.stack([mean4, truth]))[0, 1])
    finite = bool(torch.isfinite(out_c).all())
    print(f"[7 op] quad_demod_fast n={size_label(xc.shape[0])}: launches "
          f"{json.dumps(op_counts)}; "
          f"vs transmitted frequency (4-sample means) corr={corr:.6f} "
          f"finite={finite} shape={tuple(out_c.shape)}")
    if not (finite and corr > 0.99 and out_c.shape[0] == xc.shape[0] - 1):
        failures.append("quad_demod_fast output")
    del out_c
    end_phase("7")
    return op_counts


def sync_phase(dev, card: str, sizes: CoreSizes, gen: torch.Generator,
               audio, got):
    """Phase 9 on ``dev``: kernels D and E at the decode bank's shape
    (``sizes.bank_ch`` x ``sizes.bank_n``) against their plain versions
    (E also against native ``rr_symbol_sync``) and on the edge inputs of
    ``tools/sync_cases.py``; the AX.25 receiver on the corpus ``audio``
    with ``sync="events"`` (``got``: its frames with the native sync), and
    the wideband receiver on a capture of ``sizes.wb_stations`` with each
    sync method of ``sizes.wb_methods``, counted, with D and E held again
    on the arguments these paths gave them; then kernel H, the channels and
    their power, against its plain version at the bench's shape and the
    wideband cell's.  Returns the largest |error| of D, E and H, the
    events receiver's frames, and the launch counts of the events path and
    of the wideband receiver by method."""
    from rustradio_tpu_torch import native, ops
    from rustradio_tpu_torch.models import ax25, multichannel
    from rustradio_tpu_torch.ops import hdlc, kernels
    from rustradio_tpu_torch.parallel import channelizer
    from rustradio_tpu_torch.tools import sync_cases

    errs = {}
    bank_label = f"{sizes.bank_ch} x {size_label(sizes.bank_n)}"

    def outputs_equal(what, got, want) -> float:
        """Bit-equality of two wrapper results (tuples of tensors); returns
        the largest |difference| of the f32 outputs (tolerance 0)."""
        err = max(max_err(g, w) for g, w in zip(got, want))
        report("9 sync", what, err, 0.0)
        return err

    def events_check(what, args, window: int | None = None) -> float:
        """Kernel D on a path's own captured arguments against its plain
        version: every output (ev_mid, ev_clock, final fstate and istate).
        The whole call when ``window`` is None (the plain loop stops at the
        last slot holding a crossing); else the first ``window`` slots and
        the slots from ``window`` before the last crossing (of the channel
        with the most) to the end, each run from the state the kernel
        reaches there, and each also held against the whole kernel run
        (so the windows stand for it, positions near n and the padding
        tail included)."""
        events, n, *consts, fs, ist = args[:7]  # the windows run without
        full = kernels.symbol_sync_events_scan(*args)  # the path's counts
        real = int((events < n).sum(1).max())
        print(f"[9 sync] {what}: {events.shape[0]} ch x {events.shape[1]} "
              f"slots, n={n}, at most {real} crossings per channel")
        if window is None or real <= 2 * window:
            return outputs_equal(f"{what}: kernel D whole vs plain", full,
                                 kernels.symbol_sync_events_scan_plain(*args))
        a = real - window
        _, _, fa, ia = kernels.symbol_sync_events_scan(
            events[:, :a].contiguous(), n, *consts, fs, ist)
        errs_ = []
        for label, ev, f0, i0, sl in (
                ("first", events[:, :window], fs, ist, slice(0, window)),
                ("last", events[:, a:], fa, ia, slice(a, None))):
            ev = ev.contiguous()
            got = kernels.symbol_sync_events_scan(ev, n, *consts, f0, i0)
            want = kernels.symbol_sync_events_scan_plain(ev, n, *consts, f0, i0)
            errs_.append(outputs_equal(
                f"{what}: kernel D {label} {window} crossings vs plain", got,
                want))
            whole = (full[0][:, sl], full[1][:, sl])
            if label == "last":
                whole += full[2:]
            errs_.append(outputs_equal(
                f"{what}: kernel D {label} window vs the whole run",
                got[: len(whole)], whole))
        return max(errs_)

    def scan_check(what, args, window: int) -> float:
        """Kernel E on a path's own captured arguments: each channel's
        symbols over the whole call bit-equal to native ``rr_symbol_sync``
        (the path starts from the fresh state native starts from), and the
        first and last ``window`` samples against the plain version, each
        run from the state the kernel reaches there and held against the
        whole kernel run."""
        x, sps, max_dev, taps, st = args
        mask, clocks, st_out = kernels.symbol_sync_scan(*args)
        x_np = x.cpu().numpy()
        unequal = [c for c in range(x.shape[0]) if not np.array_equal(
            x[c][mask[c]].cpu().numpy(),
            native.symbol_sync_f32(x_np[c], sps, max_dev, taps))]
        print(f"[9 sync] {what}: kernel E {x.shape[0]} ch x {x.shape[1]} "
              f"samples vs native: {x.shape[0] - len(unequal)}/{x.shape[0]} "
              f"channels emit the same symbols bit for bit")
        if unequal:
            failures.append(f"{what}: kernel E differs from native on "
                            f"channels {unequal}")
        a = x.shape[1] - window
        _, _, sa = kernels.symbol_sync_scan(x[:, :a].contiguous(), sps,
                                            max_dev, taps, st)
        errs_ = []
        for label, xs, s0, sl in (("first", x[:, :window], st, slice(0, window)),
                                  ("last", x[:, a:], sa, slice(a, None))):
            xs = xs.contiguous()
            got = kernels.symbol_sync_scan(xs, sps, max_dev, taps, s0)
            want = kernels.symbol_sync_scan_plain(xs, sps, max_dev, taps, s0)
            errs_.append(outputs_equal(
                f"{what}: kernel E {label} {window} samples vs plain", got, want))
            whole = (mask[:, sl], clocks[:, sl]) + ((st_out,) if label == "last"
                                                   else ())
            errs_.append(outputs_equal(
                f"{what}: kernel E {label} window vs the whole run",
                got[: len(whole)], whole))
        return max(errs_)

    def sync_equal(what, got, want):
        """Bit-equality of (mask, clocks[, valid]) outputs: report the
        clocks' max |error| (tolerance 0) and count unequal masks."""
        err = max_err(got[1], want[1])
        report("9 sync", f"{what} clocks", err, 0.0)
        for name, a, b in zip(("mask", "valid"), (got[0], *got[2:]),
                              (want[0], *want[2:])):
            if not torch.equal(a, b):
                failures.append(f"{what}: {name} differs from the plain version")
        return err

    # ---- 9. clock recovery (kernels D and E) and the wideband receiver
    bank = decode_bank(dev, gen, sizes.bank_ch, sizes.bank_n)
    ev_out, ev_valid = ops.symbol_sync_events(bank, BANK_SPS,
                                              max_events=sizes.bank_events)
    with plain_versions():
        ev_plain, ev_pvalid = ops.symbol_sync_events(bank, BANK_SPS,
                                                     max_events=sizes.bank_events)
    errs["symbol_sync_events"] = sync_equal(
        f"kernel D {bank_label} sps {BANK_SPS} max_events {sizes.bank_events}",
        (ev_out[1], ev_out[2], ev_valid), (ev_plain[1], ev_plain[2], ev_pvalid))
    if not bool(ev_valid.all()):
        failures.append("decode bank: a channel overflowed its slot budget")
    (sc_v, sc_m, _), _ = ops.symbol_sync(bank, BANK_SPS)
    bank_np = bank.cpu().numpy()
    unequal = [c for c in range(sizes.bank_ch) if not np.array_equal(
        ops.compact(sc_v[c], sc_m[c]).cpu().numpy(),
        native.symbol_sync_f32(bank_np[c], BANK_SPS, 0.5, (0.5, 0.5)))]
    print(f"[9 sync] kernel E {bank_label} vs native rr_symbol_sync: "
          f"{sizes.bank_ch - len(unequal)}/{sizes.bank_ch} channels emit the "
          f"same symbols bit for bit ({int(sc_m.sum())} symbols)")
    if unequal:
        failures.append(f"kernel E differs from native on channels {unequal}")
    prefix = bank[:, : sizes.sync_prefix].contiguous()
    (_, pm, pc), pst = ops.symbol_sync(prefix, BANK_SPS)
    with plain_versions():
        (_, qm, qc), qst = ops.symbol_sync(prefix, BANK_SPS)
    n_prefix = size_label(sizes.sync_prefix)
    errs["symbol_sync_scan"] = sync_equal(
        f"kernel E {sizes.bank_ch} x {n_prefix} prefix", (pm, pc), (qm, qc))
    report("9 sync", f"kernel E {n_prefix} prefix final state",
           max(max_err(pst[k].float(), qst[k].float()) for k in pst), 0.0)
    end_phase("9 sync")

    # kernels D and E where their tiled, block-per-channel design can break
    # (tools/sync_cases.py: sizes around a tile and the two in flight,
    # misaligned rows, silence, chatter, crossings on a tile's edges, sps
    # 2.5 to 100, 1 to 16 taps, cut streams): every output of the kernels
    # on the card against the plain versions on CPU tensors, the chained
    # runs against the whole ones
    edge_cases = [c for c in sync_cases.cases(SEED)
                  if sizes.edge_cases is None or c.name in sizes.edge_cases]
    unequal, compared = [], 0
    for case in edge_cases:
        got_e = sync_cases.run_case(case, dev)
        compared += len(got_e)
        unequal += [f"{case.name}: {k}" for k in
                    sync_cases.mismatches(got_e, sync_cases.run_case(case, "cpu"))
                    + sync_cases.self_mismatches(got_e)]
    print(f"[9 edges] kernels D and E on {len(edge_cases)} edge cases "
          f"({', '.join(c.name for c in edge_cases)}): {compared} outputs "
          f"against the plain versions, bit for bit; unequal: {unequal}")
    report("9 edges", "kernels D and E vs plain, unequal outputs",
           float(len(unequal)), 0.0)
    report("9 edges", "kernel E's jump between events: every f32 position "
           f"in [1, 2^{sizes.jump_binades}) x runs of 1..64 up to the walker's "
           "limit, pairs where pos + run differs from run additions of 1",
           float(jump_mismatches(dev, sizes.jump_binades, sizes.jump_step)), 0.0)
    end_phase("9 edges")

    # the AX.25 receiver on the corpus with the device clock recovery
    n_frames = sizes.frames
    zero_counts()
    with capturing("symbol_sync_events_scan") as ax_calls:
        ev_got = decoded(ax25.ax25_1200_rx(audio, FS_AUDIO, sync="events"),
                         n_frames)
    ev_counts = dict(kernels.LAUNCHES)
    print(f"[9 ax25 events] ax25_1200_rx(sync='events') decoded "
          f"{len(set(ev_got))}/{n_frames}; native sync decoded {len(set(got))}; launches "
          f"{json.dumps(ev_counts)}")
    require("AX.25 events", ev_counts, ("fir_decimate", "symbol_sync_events"))
    if len(set(ev_got)) < sizes.frame_gate:
        failures.append(f"ax25_1200_rx(sync='events'): {len(set(ev_got))} < "
                        f"{sizes.frame_gate}")
    # the kernel on the path's own arguments
    errs["symbol_sync_events"] = max(errs["symbol_sync_events"], events_check(
        "AX.25 events path", ax_calls["symbol_sync_events_scan"][0],
        window=sizes.sync_window))
    del ax_calls
    end_phase("9 ax25 events")

    # the wideband receiver at full width, both sync methods
    stations, wb_frames = sizes.wb_stations, sizes.wb_frames
    wide = wideband_capture(hdlc, dev, gen, stations, wb_frames)
    print(f"[9 wideband] capture: {len(stations)} stations on channels "
          f"{list(stations)} of {WB_CHANNELS}, {len(stations) * wb_frames} "
          f"frames, {wide.shape[0]} samples at {FS_WB:.0f} Hz "
          f"({wide.shape[0] / FS_WB:.1f} s), noise {WB_NOISE} per component")
    want_wb = {(stations[i // wb_frames], corpus_payload(i))
               for i in range(len(stations) * wb_frames)}
    wb_counts = {}
    for method in sizes.wb_methods:
        zero_counts()
        with capturing("symbol_sync_scan", "symbol_sync_events_scan") as calls:
            res = multichannel.decode_band_ax25(
                wide, FS_WB, n_channels=WB_CHANNELS, max_active=len(stations),
                sync_method=method)
        wb_counts[method] = dict(kernels.LAUNCHES)
        found = {(r.channel, bytes(p)) for r in res for p in r.packets}
        ok = len(found & want_wb)
        chans = sorted(r.channel for r in res)
        print(f"[9 wideband] decode_band_ax25 sync {method}: {ok}/{len(want_wb)} "
              f"frames on their channels, channels decoded {chans}, "
              f"{sum(len(r.packets) for r in res)} packets; launches "
              f"{json.dumps(wb_counts[method])}")
        require(f"wideband {method}", wb_counts[method],
                ("pfb_channelize", "fir_decimate", f"symbol_sync_{method}"))
        if chans != sorted(stations):
            failures.append(f"wideband {method}: channels {chans} decoded")
        if ok < sizes.wb_floor:
            failures.append(f"wideband {method}: {ok} < {sizes.wb_floor} frames")
        # the kernels at the shapes this path gave them (E also re-runs
        # the channels that overflowed their event budget)
        for args in calls["symbol_sync_events_scan"][:1]:
            errs["symbol_sync_events"] = max(errs["symbol_sync_events"],
                                             events_check(f"wideband {method}",
                                                          args))
        for args in calls["symbol_sync_scan"][:1]:
            errs["symbol_sync_scan"] = max(errs["symbol_sync_scan"], scan_check(
                f"wideband {method}", args, sizes.sync_window))
        del calls
    del wide
    end_phase("9 wideband")

    # kernel H, the channels and their power, against its plain version
    # (the torch form, cuFFT) at the bench's shape and the wideband cell's
    errs["pfb_channelize"] = 0.0
    for m, n in ((PFB_CH, sizes.pfb_n), (CELL_CH, sizes.pfb_cell_n)):
        x = torch.complex(torch.randn(n, generator=gen, device=dev),
                          torch.randn(n, generator=gen, device=dev))
        taps = channelizer.channelizer_taps(m)
        ch, power = kernels.pfb_channelize(x, taps, m, power=True)
        plain = kernels.pfb_channelize_plain(x, taps, m)
        del x
        err = float((ch - plain).abs().max())
        rms = float(plain.abs().pow(2).mean().sqrt())
        want = kernels.pfb_power_plain(plain)
        rel = float(((power - want).abs() / want).max())
        del ch, plain
        print(f"[9 channelizer] kernel H pfb_channelize {m} x {size_label(n)} "
              f"vs plain: channels max_abs_err={err:.3e} ({err / rms:.3e} of "
              f"their RMS, tol {PFB_TOL:.1e}), power {rel:.3e} relative (tol "
              f"{PFB_POWER_TOL:.1e})")
        if err > PFB_TOL * rms or not rel <= PFB_POWER_TOL:
            failures.append(f"9 channelizer {m} x {size_label(n)}: kernel H vs plain")
        errs["pfb_channelize"] = max(errs["pfb_channelize"], err)
    end_phase("9 channelizer")
    return errs, ev_got, ev_counts, wb_counts


# ---- phase 10: the FM family's apps and the streaming Graph

FS_RTL = 1_024_000.0      # rtl_fm's default rate: the main path's capture
AUDIO_RATE = 48_000.0     # rtl_fm's and am_decode's default audio rate
APP_TONES = ((1000.0, 0.6), (3100.0, 0.3))  # rtl_fm_iq's modulating audio
AM_TONE, AM_DEPTH = 1000.0, 0.6
PCM = 1 / 32767           # one step of the .au encoding
STREAM_CHUNK = 1 << 18    # run_stream's default chunk
RESUME_AFTER = 20         # chunks before the checkpointed pause


@dataclasses.dataclass(frozen=True)
class AppsSizes:
    """Phase 10's sizes: the defaults on the card; a CPU rehearsal
    (``tests/test_torch_chip_smoke.py``) takes small ones.  The FM apps
    run on the whole main capture given."""

    frames: int = N_FRAMES            # corpus frames of the audio given
    frame_gate: int = FRAME_GATE
    stream_chunk: int = STREAM_CHUNK  # run_stream's chunk
    resume_after: int = RESUME_AFTER  # chunks before the checkpointed pause


def tone_fit(audio: np.ndarray, rate: float, tones, skip: int = 256):
    """Least-squares fit of ``audio[skip:-skip]`` on a sine and a cosine
    of each tone: (each tone's amplitude, residual rms / audio rms)."""
    k = np.arange(skip, len(audio) - skip)
    cols = []
    for f, _ in tones:
        w = 2 * np.pi * f / rate * k
        cols += [np.sin(w), np.cos(w)]
    a = np.stack(cols, 1)
    y = audio[k].astype(np.float64)
    y = y - y.mean()
    coef = np.linalg.lstsq(a, y, rcond=None)[0]
    amps = [float(np.hypot(coef[2 * i], coef[2 * i + 1])) for i in range(len(tones))]
    return amps, float(np.sqrt(np.mean((y - a @ coef) ** 2) / np.mean(y * y)))


def deemphasis_gain(f: float, rate: float) -> float:
    """|H| at ``f`` of wbfm_rx's 75 us single-pole de-emphasis at ``rate``."""
    dt = 1.0 / rate
    alpha = dt / (75e-6 + dt)
    return abs(alpha / (1 - (1 - alpha) * np.exp(-2j * np.pi * f / rate)))


def envelope_ratio(y: torch.Tensor, skip: int) -> float:
    """max|y| / min|y| of a filtered stream past its first ``skip``
    samples (the filter's start-up ramp)."""
    m = y[skip:].abs()
    return float(m.max() / m.min())


def ax25_receiver(audio, sync: str, upto=None, sink=None):
    """The chain of ``ax25_1200_rx_graph`` as a Graph of its own (for a
    checkpointed run), or its first ``upto`` blocks into ``sink`` (a
    NullSink by default): (graph, sink)."""
    from rustradio_tpu_torch import blocks, taps as tapgen
    from rustradio_tpu_torch.graph import Graph

    chain = [blocks.VectorSource(audio),
             blocks.FftFilterFloat(tapgen.band_pass(FS_AUDIO, 400.0, 2700.0,
                                                    65, "hamming")),
             blocks.Hilbert(65), blocks.QuadratureDemod(1.0),
             blocks.FftFilterFloat(tapgen.low_pass(FS_AUDIO, 1100.0, 200.0,
                                                   "hamming")),
             blocks.AddConst(-float(np.float32(2.0 * np.pi * 1700.0 / FS_AUDIO))),
             blocks.SymbolSync(FS_AUDIO / 1200.0, 0.5, (1 / 6,) * 6,
                               method=sync),
             blocks.BinarySlicer(), blocks.NrziDecode(),
             blocks.HdlcDeframer(10, 1500)]
    if sink is None:
        sink = blocks.PduVectorSink() if upto is None else blocks.NullSink()
    g = Graph()
    g.chain(*chain[:upto], sink)
    return g, sink


def batch_sink():
    """A sink that keeps every chunk on the device and takes a batch of
    ``run_stream(scan_chunks=)`` in one call; ``data()`` is the stream."""
    from rustradio_tpu_torch.blocks.base import Block

    class BatchSink(Block):
        graph_capturable = False  # a sink
        n_out = 0
        domain = "device"

        def __init__(self):
            self.parts = []

        def apply(self, x):
            self.parts.append(x)
            return ()

        def accept_batch(self, stacked):
            self.parts.append(stacked.reshape(-1))

        def data(self):
            return torch.cat(self.parts)

    return BatchSink()


def hold_fir_calls(phase: str, what: str, calls) -> float:
    """Kernel A on each of a path's captured ``fir_decimate`` calls against
    its plain version on the same arguments, at the FIR budget: the worst
    |error| over max|y| of its own call against 2e-5.  Returns the largest
    |error|."""
    from rustradio_tpu_torch.ops import kernels

    worst_abs = worst_rel = 0.0
    for args in calls:
        got, want = (torch.view_as_real(t) if t.is_complex() else t
                     for t in (kernels.fir_decimate(*args),
                               kernels.fir_decimate_plain(*args)))
        err = max_err(got, want)
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(float(want.abs().max()), 1e-30))
    report(phase, f"{what}: kernel A on each of its {len(calls)} calls vs "
           "plain, |error| / max|y| of the call", worst_rel, 2e-5)
    return worst_abs


def hold_events_calls(phase: str, what: str, calls) -> float:
    """Kernel D on each of a path's captured ``symbol_sync_events_scan``
    calls (a streamed path: one chunk each, the state carried in from the
    chunk before) against its plain version on the same arguments, every
    slot and the final state bit for bit.  The plain loop runs the calls
    of one ``n`` together, each call's channels as channels of one call
    (they are independent), each padded with ``n`` to the longest.
    Returns the largest |error| (tolerance 0)."""
    from rustradio_tpu_torch.ops import kernels

    groups: dict[tuple, list] = {}
    for args in calls:
        key = (args[1], args[2], args[3],
               tuple(np.asarray(args[4], np.float64).ravel()))
        groups.setdefault(key, []).append(args)
    err, slots = 0.0, 0
    for (n, sps, max_dev, _), group in groups.items():
        taps = group[0][4]
        rows = sum(a[0].shape[0] for a in group)
        width = max(a[0].shape[1] for a in group)
        events = torch.full((rows, width), n, dtype=group[0][0].dtype,
                            device=group[0][0].device)
        row = 0
        for a in group:
            c, e = a[0].shape
            events[row:row + c, :e] = a[0]
            row += c
        want = kernels.symbol_sync_events_scan_plain(
            events, n, sps, max_dev, taps, torch.cat([a[5] for a in group]),
            torch.cat([a[6] for a in group]))
        row = 0
        for a in group:
            c, e = a[0].shape
            got = kernels.symbol_sync_events_scan(*a)
            err = max(err, max_err(got[0], want[0][row:row + c, :e]),
                      max_err(got[1], want[1][row:row + c, :e]),
                      max_err(got[2], want[2][row:row + c]),
                      max_err(got[3], want[3][row:row + c]))
            slots += c * e
            row += c
    report(phase, f"{what}: kernel D on each of its {len(calls)} calls "
           f"({slots} slots) vs plain, every slot and the final state",
           err, 0.0)
    return err


D_WINDOW = 1 << 14    # slots of each window where kernel D is held on the host
E_WINDOW = 1 << 14    # samples of each window where kernel E is held there


def _on_host(args):
    return tuple(a.cpu() if torch.is_tensor(a) else a for a in args)


def hold_events_windows(phase: str, what: str, calls,
                        window: int = D_WINDOW) -> float:
    """Kernel D on each of a path's captured ``symbol_sync_events_scan``
    calls against its plain loop on the host (one slot a step) on two
    windows of ``window`` slots: the first, from the call's own state, and
    the last that holds a crossing, from the state the kernel reaches
    there (the whole call where it has at most ``2 * window`` crossing
    slots).  Every slot and the state after each window bit for bit, and
    each window also against the whole call's kernel run, so the windows
    stand for it.  The slots between them are held only through what the
    path decodes.  Returns the largest |error| (tolerance 0; inf when
    there is no call)."""
    kernels = _kernels()
    err, held, slots = (0.0 if calls else math.inf), 0, 0
    for args in calls:
        events, n, *consts, fs, ist = args[:7]
        counts = args[7] if len(args) > 7 else None
        whole = kernels.symbol_sync_events_scan(*args)
        real = int((events < n).sum(1).max()) if events.numel() else 0
        slots += int((events < n).sum())
        if real <= 2 * window:
            windows = [(args, slice(None), True)]
        else:
            a = real - window
            cut = (lambda k: counts.clamp(max=k)) if counts is not None else None
            _, _, fa, ia = kernels.symbol_sync_events_scan(
                events[:, :a].contiguous(), n, *consts, fs, ist,
                *([cut(a)] if cut else []))
            windows = [
                ((events[:, :window].contiguous(), n, *consts, fs, ist,
                  *([cut(window)] if cut else [])), slice(0, window), False),
                ((events[:, a:].contiguous(), n, *consts, fa, ia,
                  *([(counts - a).clamp(min=0)] if cut else [])),
                 slice(a, None), True)]
        for wargs, sl, last in windows:
            got = kernels.symbol_sync_events_scan(*wargs)
            want = kernels.symbol_sync_events_scan_plain(*_on_host(wargs))
            of_whole = (whole[0][:, sl], whole[1][:, sl]) + (
                whole[2:] if last else ())
            err = max([err] + [max_err(g.cpu(), w) for g, w in zip(got, want)]
                      + [max_err(g, w) for g, w in zip(got, of_whole)])
            held += int((wargs[0] < n).sum())
    report(phase, f"{what}: kernel D on each of its {len(calls)} calls, "
           f"{held} of its {slots} crossing slots (up to the first and the "
           f"last {window} of each channel) vs the plain loop: every slot, "
           "the state after them and the whole run there", err, 0.0)
    return err


def hold_scan_calls(phase: str, what: str, calls, window: int = E_WINDOW) -> float:
    """Kernel E on each of a path's captured ``symbol_sync_scan`` calls
    against its plain version on the host, as kernel D above: the first
    and the last ``window`` samples of each channel (the whole call where
    it has at most ``2 * window``), every output bit for bit and against
    the whole kernel run.  Returns the largest |error| (tolerance 0; inf
    when there is no call)."""
    kernels = _kernels()
    err, held, samples = (0.0 if calls else math.inf), 0, 0
    for args in calls:
        x, *consts, st = args
        mask, clocks, st_out = kernels.symbol_sync_scan(*args)
        samples += x.numel()
        if x.shape[1] <= 2 * window:
            windows = [(args, slice(None), True)]
        else:
            a = x.shape[1] - window
            _, _, sa = kernels.symbol_sync_scan(x[:, :a].contiguous(), *consts, st)
            windows = [((x[:, :window].contiguous(), *consts, st),
                        slice(0, window), False),
                       ((x[:, a:].contiguous(), *consts, sa), slice(a, None), True)]
        for wargs, sl, last in windows:
            got = kernels.symbol_sync_scan(*wargs)
            want = kernels.symbol_sync_scan_plain(*_on_host(wargs))
            of_whole = (mask[:, sl], clocks[:, sl]) + ((st_out,) if last else ())
            err = max([err] + [max_err(g.cpu(), w) for g, w in zip(got, want)]
                      + [max_err(g, w) for g, w in zip(got, of_whole)])
            held += wargs[0].numel()
    report(phase, f"{what}: kernel E on each of its {len(calls)} calls, "
           f"{held} of its {samples} samples vs the plain version: every "
           "output and the whole run there", err, 0.0)
    return err


def apps_phase(dev, card, sizes: AppsSizes, i_main, q_main, audio, want_lists):
    """Phase 10: ``rtl_fm`` (c32, u8 w3, u8 i8) on the main path's capture,
    ``am_decode`` on an AM capture and ``wbfm_rx`` on the station, each at
    2^24 samples and held against the same call on the kernels' plain
    versions; then ``ax25_1200_rx_graph`` on the corpus with both sync
    methods, offline and streamed, a streamed run paused at a checkpoint
    and resumed, and kernels A and D on the streamed path's own calls
    against their plain versions, at ``sizes`` (a CPU rehearsal takes
    small ones).  Returns the launch counts of each path and the largest
    |error| of each kernel held here."""
    import tempfile
    from pathlib import Path

    from rustradio_tpu_torch import ops, taps as tapgen
    from rustradio_tpu_torch.apps import am_decode, rtl_fm
    from rustradio_tpu_torch.io import au, rawfile
    from rustradio_tpu_torch.models import ax25, fm
    from rustradio_tpu_torch.ops import kernels

    counts = {}
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    n = i_main.shape[0]
    # the capture of the main path as files: u8 by rtlsdr_encode (the planes
    # sit on its grid, (u8 - 127)/128, so the bytes are exact) and c32
    iq = torch.complex(i_main, q_main).cpu().numpy()
    u8 = rawfile.rtlsdr_encode(iq * np.float32(128 * 0.008))
    u8.tofile(d / "fm.u8")
    iq.tofile(d / "fm.c32")
    back = (u8.reshape(-1, 2).astype(np.float32) - 127.0) / 128.0
    if not (np.array_equal(back[:, 0], iq.real) and np.array_equal(back[:, 1], iq.imag)):
        failures.append("rtlsdr_encode: the u8 capture is not the planes' grid")
    gain = FS_RTL / (2 * np.pi * 75_000.0)
    lp = tapgen.low_pass_complex(FS_RTL, 100_000.0, 50_000.0, "hamming")
    x = torch.from_numpy(iq).to(dev)
    with plain_versions():
        y_ratio = envelope_ratio(ops.filter_complex(x, lp), len(lp))
    for mode, args in (("c32", ["-r", str(d / "fm.c32")]),
                       ("w3", ["-r", str(d / "fm.u8"), "--rtl_u8"]),
                       ("i8", ["-r", str(d / "fm.u8"), "--rtl_u8", "--precision",
                               "i8"])):
        out, plain_out = d / f"{mode}.au", d / f"{mode}_plain.au"
        zero_counts()
        args = args + ["--device", str(dev)]
        rtl_fm.main(args + ["--out", str(out)])
        counts[f"rtl_fm {mode}"] = dict(kernels.LAUNCHES)
        with plain_versions():
            rtl_fm.main(args + ["--out", str(plain_out)])
        got, want = au.au_read(str(out))[0], au.au_read(str(plain_out))[0]
        if mode == "c32":
            # kernel A at 2e-5 of max|y| on each sample of a pair, through
            # the exact discriminator: 2 * 2e-5 * max|y| / min|y| rad (past
            # the 49-tap ramp: from the third audio sample on), times the
            # gain, plus two PCM steps
            tol = 2 * 2e-5 * y_ratio * gain + 2 * PCM
            err = float(np.abs(got[3:] - want[3:]).max()) if len(got) == len(want) else math.inf
        else:
            tol = BUDGET[mode] * gain + 2 * PCM  # kernel B's budget
            err = float(np.abs(got - want).max()) if len(got) == len(want) else math.inf
        report("10 rtl_fm", f"rtl_fm {mode} 2^{n.bit_length() - 1} samples: .au "
               f"audio vs the plain versions", err, tol)
        amps, resid = tone_fit(got, AUDIO_RATE, APP_TONES)
        print(f"[10 rtl_fm] rtl_fm {mode}: {len(got)} audio samples, tones "
              f"{[round(a, 4) for a in amps]} (sent {[a for _, a in APP_TONES]}), "
              f"residual {resid:.4f} of the audio; launches "
              f"{json.dumps(counts[f'rtl_fm {mode}'])}; card: {card}")
        if not (len(got) == -(-n * 3 // 64)
                and all(abs(a / s - 1) < 0.05 for a, (_, s) in zip(amps, APP_TONES))
                and resid < 0.25):
            failures.append(f"rtl_fm {mode}: the tones did not come out")
        require(f"rtl_fm {mode}", counts[f"rtl_fm {mode}"],
                ("fir_decimate",) if mode == "c32" else ("fm_chain",))

    # WBFM: the same station through wbfm_rx (channel filter on kernel A)
    lpw = tapgen.low_pass_complex(FS_RTL, 100_000.0, 25_000.0, "hamming")
    with plain_versions():
        w_ratio = envelope_ratio(ops.filter_complex(x, lpw), len(lpw))
    zero_counts()
    got_w = fm.wbfm_rx(x, FS_RTL)
    counts["wbfm_rx"] = dict(kernels.LAUNCHES)
    with plain_versions():
        want_w = fm.wbfm_rx(x, FS_RTL)
    # as rtl_fm c32 (the de-emphasis has gain <= 1)
    report("10 wbfm", f"wbfm_rx 2^{n.bit_length() - 1} samples vs the plain "
           "versions (past the ramp)", max_err(got_w[3:], want_w[3:]), 2 * 2e-5 * w_ratio * gain + 1e-6)
    amps, resid = tone_fit(got_w.cpu().numpy(), AUDIO_RATE, APP_TONES)
    sent = [a * deemphasis_gain(f, AUDIO_RATE) for f, a in APP_TONES]
    print(f"[10 wbfm] wbfm_rx: tones {[round(a, 4) for a in amps]} (sent, "
          f"de-emphasized {[round(a, 4) for a in sent]}), residual {resid:.4f}; "
          f"launches "
          f"{json.dumps(counts['wbfm_rx'])}; card: {card}")
    if not (all(abs(a / s - 1) < 0.05 for a, s in zip(amps, sent)) and resid < 0.25):
        failures.append("wbfm_rx: the tones did not come out")
    require("wbfm_rx", counts["wbfm_rx"], ("fir_decimate",))
    del x, got_w, want_w

    # AM: a 1 kHz tone at 60% depth on a carrier 2.5 kHz off centre, noise
    t = torch.arange(n, dtype=torch.float64, device=dev) / FS_RTL
    env = 0.5 * (1 + AM_DEPTH * torch.sin(2 * math.pi * AM_TONE * t))
    am = torch.polar(env, 2 * math.pi * 2500.0 * t + 0.3).to(torch.complex64)
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    am += 0.01 * torch.complex(torch.randn(n, generator=gen, device=dev),
                               torch.randn(n, generator=gen, device=dev))
    am.cpu().numpy().tofile(d / "am.c32")
    lpa = tapgen.low_pass_complex(FS_RTL, 12_500.0, 10_000.0, "hamming")
    lp2 = tapgen.low_pass(FS_RTL, AUDIO_RATE, 500.0, "hamming")
    with plain_versions():
        y_max = float(ops.filter_complex(am, lpa).abs().max())
    del t, env, am
    args = ["-r", str(d / "am.c32"), "--sample_rate", "1.024m", "--device",
            str(dev)]
    zero_counts()
    am_decode.main(args + ["-o", str(d / "am.f32")])
    counts["am_decode"] = dict(kernels.LAUNCHES)
    with plain_versions():
        am_decode.main(args + ["-o", str(d / "am_plain.f32")])
    got_a = np.fromfile(d / "am.f32", "<f4")
    want_a = np.fromfile(d / "am_plain.f32", "<f4")
    # kernel A's 2e-5 * max|y| through |.| and the audio low-pass (sum |taps|)
    tol = 2e-5 * y_max * float(np.abs(lp2).sum()) + 1e-6
    report("10 am", f"am_decode 2^{n.bit_length() - 1} samples ({len(lpa)}-tap "
           f"channel filter, "
           f"{len(lp2)}-tap audio low-pass) vs the plain versions",
           float(np.abs(got_a - want_a).max()) if got_a.shape == want_a.shape
           else math.inf, tol)
    amps, resid = tone_fit(got_a, AUDIO_RATE, ((AM_TONE, 0.0),))
    print(f"[10 am] am_decode: tone {amps[0]:.4f} (sent {0.5 * AM_DEPTH}), "
          f"residual {resid:.4f}; launches "
          f"{json.dumps(counts['am_decode'])}; card: {card}")
    if not (abs(amps[0] / (0.5 * AM_DEPTH) - 1) < 0.05 and resid < 0.1):
        failures.append("am_decode: the tone did not come out")
    require("am_decode", counts["am_decode"], ("fir_decimate",))
    tmp.cleanup()
    end_phase("10 apps")

    # the AX.25 receiver built from blocks, offline and streamed
    def receiver(sync, upto=None):
        return ax25_receiver(audio, sync, upto)

    for sync, want in want_lists.items():
        for chunk in (None, sizes.stream_chunk):
            label = f"{sync} {'streamed' if chunk else 'offline'}"
            zero_counts()
            out = ax25.ax25_1200_rx_graph(audio, FS_AUDIO, chunk_size=chunk,
                                          sync=sync, device=dev)
            counts[f"graph {label}"] = dict(kernels.LAUNCHES)
            got = decoded(out, sizes.frames)
            print(f"[10 ax25 graph] ax25_1200_rx_graph sync={label} (chunks of "
                  f"{chunk or audio.shape[0]}): {len(set(got))}/{sizes.frames} "
                  f"decoded, same list as ax25_1200_rx: {got == want}; launches "
                  f"{json.dumps(counts[f'graph {label}'])}; card: {card}")
            if len(set(got)) < sizes.frame_gate or got != want:
                failures.append(f"ax25_1200_rx_graph {label}: {len(set(got))} "
                                "frames, or not ax25_1200_rx's list")
            require(f"ax25 graph {label}", counts[f"graph {label}"],
                    ("fir_decimate", "symbol_sync_events") if sync == "events"
                    else ("fir_decimate",))
    with tempfile.TemporaryDirectory() as ck_dir:
        ck = str(Path(ck_dir) / "events.pkl")
        zero_counts()
        g, first = receiver("events")
        g.run_stream(chunk_size=sizes.stream_chunk, max_chunks=sizes.resume_after,
                     checkpoint_path=ck, checkpoint_every=sizes.resume_after, device=dev)
        g, rest = receiver("events")
        g.run_stream(chunk_size=sizes.stream_chunk, resume_from=ck, device=dev)
        counts["graph events resumed"] = dict(kernels.LAUNCHES)
    a = decoded([bytes(np.asarray(p.data)) for p in first.pdus()], sizes.frames)
    b = decoded([bytes(np.asarray(p.data)) for p in rest.pdus()], sizes.frames)
    print(f"[10 ax25 graph] events streamed, paused after {sizes.resume_after} chunks "
          f"at a checkpoint ({len(a)} frames), resumed ({len(b)} frames): "
          f"the uninterrupted list "
          f"{a + b == want_lists['events']}; launches "
          f"{json.dumps(counts['graph events resumed'])}; card: {card}")
    if a + b != want_lists["events"] or not a or not b:
        failures.append("ax25 graph: the resumed stream is not the uninterrupted one")
    require("ax25 graph resumed", counts["graph events resumed"],
            ("fir_decimate", "symbol_sync_events"))

    # the streamed path's own calls of kernels A (chunks plus the filters'
    # history) and D (the state carried in from the chunk before), once
    # more outside the counted runs, each held against its plain version
    with capturing("fir_decimate", "symbol_sync_events_scan") as calls:
        out = ax25.ax25_1200_rx_graph(audio, FS_AUDIO, chunk_size=sizes.stream_chunk,
                                      sync="events", device=dev)
    if decoded(out, sizes.frames) != want_lists["events"]:
        failures.append("ax25 graph: the captured streamed run differs")
    what = f"ax25_1200_rx_graph events streamed (chunks of {sizes.stream_chunk})"
    call_errs = {
        "fir_decimate": hold_fir_calls("10 ax25 graph", what,
                                       calls["fir_decimate"]),
        "symbol_sync_events": hold_events_calls(
            "10 ax25 graph", what, calls["symbol_sync_events_scan"])}
    del calls
    end_phase("10 ax25 graph")
    return counts, call_errs


# ---- phase 11: the G3RUH modem and the burst receivers (WPCR)

FS_G3 = 300_000.0         # the 9600 bd apps' default rate (apps/ax25_9600_rx.py)
FS_AFSK = 50_000.0        # ax25_1200_wpcr's default rate
N_G3 = 200                # corpus frames on each capture
G3_GATE = 196             # of them decoded on each capture
G3_NOISE = 0.05           # the stream's complex noise per component (amplitude 0.5)
G3_MAX_DEV = 0.05         # ax25_9600_rx's clock bound (--symbol_max_deviation)
G3_GAP, G3_GAP_NOISE = 0.05, 1e-3      # s of noise between the G3RUH bursts
AFSK_GAP, AFSK_GAP_NOISE = 0.1, 0.01   # and between the AFSK bursts
BURST_THRESHOLD = 0.01
WPCR_GATE = 100           # the JAX package's gate on its WPCR corpus
BURST_CHUNK = 1 << 16     # run_stream's chunk for the block-built front half


@dataclasses.dataclass(frozen=True)
class BurstSizes:
    """Phase 11's sizes: the defaults on the card; a CPU rehearsal
    (``tests/test_torch_chip_smoke.py``) takes small ones."""

    frames: int = N_G3                # corpus frames on each capture
    gate: int = G3_GATE
    wpcr_bursts: int = 200            # bursts of the WPCR corpus
    wpcr_gate: int = WPCR_GATE
    burst_chunk: int = BURST_CHUNK


def noisy(iq: torch.Tensor, sigma: float, gen: torch.Generator) -> torch.Tensor:
    """``iq`` plus complex noise of ``sigma`` per component."""
    n = iq.shape[0]
    return iq + torch.complex(sigma * torch.randn(n, generator=gen, device=iq.device),
                              sigma * torch.randn(n, generator=gen, device=iq.device))


def burst_capture(bursts, gap: int, sigma: float, gen: torch.Generator):
    """The bursts one after another, ``gap`` samples apart and before the
    first and after the last, with complex noise of ``sigma`` per component
    over the whole capture."""
    z = torch.zeros(gap, dtype=torch.complex64, device=bursts[0].device)
    parts = [z]
    for b in bursts:
        parts += [b, z]
    return noisy(torch.cat(parts), sigma, gen)


def afsk_burst(i: int, hdlc, ops, dev) -> torch.Tensor:
    """Corpus frame i as Bell-202 AFSK at FS_AFSK frequency-modulating a
    carrier, as tests/test_models_extra.py:51-62: conj(vco(0.3 * audio))
    at 3.5 kHz a unit."""
    audio = afsk(corpus_line(i, hdlc), 1200.0, 0.5, FS_AFSK, 0)
    iq, _ = ops.vco(torch.from_numpy(0.3 * audio).to(dev),
                    2 * np.pi * 3500.0 / FS_AFSK)
    return iq.conj().resolve_conj()


def wpcr_corpus(hdlc, n: int = 200):
    """tests/test_decode_rate.py:203-228: 200 NRZ bursts at 10 samples a
    symbol with clock drift of +-1% and noise 0 to 0.55, numpy
    RandomState(5) (its first ``n``)."""
    rng = np.random.RandomState(5)
    bursts, payloads = [], []
    for i in range(n):
        p = f"W#{i:03d} wpcr corpus".encode()
        framed = hdlc.hdlc_frame(hdlc.fcs_add(np.frombuffer(p, np.uint8)))
        line = ((1 + np.cumsum(1 - np.asarray(framed))) % 2) * 2.0 - 1.0
        sps = 10.0 * (1 + ((i % 5) - 2) / 2 * 0.01)
        n = int(len(line) * sps)
        idx = np.minimum((np.arange(n) / sps).astype(int), len(line) - 1)
        x = line[idx].astype(np.float32)
        x += rng.randn(n).astype(np.float32) * [0.0, 0.1, 0.25, 0.4, 0.55][i % 5]
        bursts.append(x)
        payloads.append(p)
    return bursts, payloads


def wpcr_moved(centred: np.ndarray, syms: np.ndarray, info: dict, want) -> int:
    """The port's WPCR result on a centred burst against ``wpcr_numpy``'s
    (``want``): -1 unless both found the burst with the same bin (sps =
    bin / len) and the same symbol count, and every symbol sits where the
    numpy model's sequential f32 phase accumulator puts it, but where that
    and the closed form the port keeps (as the JAX package) round
    u_k = phase + k * sps to two sides of an integer (within 1e-4): there a
    symbol moves by one sample.  Else the count of such moved symbols.  The
    closed form's positions are held against the port's symbols first."""
    if want is None or not info["found"]:
        return 0 if want is None and not info["found"] else -1
    sps, n = np.float32(info["sps"]), len(centred)
    if info["sps"] != want[1] or info["bin"] != round(want[1] * n):
        return -1
    u = np.float32(info["phase"]) + np.arange(n, dtype=np.float32) * sps
    fl = np.floor(u)
    got_k = np.flatnonzero(np.concatenate([u[:1] >= 1.0, fl[1:] > fl[:-1]]))
    seq, ph = [], np.float32(info["phase"])
    for k in range(n):
        if ph >= 1.0:
            ph -= np.float32(1.0)
            seq.append(k)
        ph += sps
    want_k = np.asarray(seq, np.int64)
    if (not np.array_equal(centred[got_k], syms) or len(got_k) != len(want_k)
            or len(want_k) != len(want[0])):
        return -1
    u64 = np.float64(info["phase"]) + np.arange(n) * np.float64(sps)
    near = np.abs(u64 - np.round(u64)) < 1e-4
    moved = np.flatnonzero(got_k != want_k)
    for k in moved:
        a, b = sorted((int(got_k[k]), int(want_k[k])))
        if b - a != 1 or not near[a:b + 1].any():
            return -1
    return len(moved)


def burst_phase(dev, card, sizes: BurstSizes):
    """Phase 11: the G3RUH modem and the burst receivers on their captures
    (see the module docstring), at ``sizes`` (a CPU rehearsal takes small
    ones).  Returns the launch counts of each path and the largest |error|
    of each kernel held here."""
    import io
    import tempfile
    from pathlib import Path

    from rustradio_tpu_torch import blocks, ops, taps as tapgen
    from rustradio_tpu_torch.apps import (ax25_1200_wpcr, ax25_9600_rx,
                                          ax25_9600_wpcr, burst_saver, g3ruh)
    from rustradio_tpu_torch.graph import Graph
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import hdlc, kernels
    from rustradio_tpu_torch.ops.wpcr import wpcr_numpy
    from rustradio_tpu_torch.utils.checkpoint import load_checkpoint

    counts, call_errs = {}, {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    frames = [np.frombuffer(corpus_payload(i), np.uint8) for i in range(sizes.frames)]

    # the captures; the transmitter's kernel-A calls (the 723-tap channel
    # filter at 300 kHz, both planes) each held against the plain version
    zero_counts()
    with capturing("fir_decimate") as calls:
        clean = ax25.g3ruh_modulate(frames, FS_G3, device=dev)
        g3_one = [ax25.g3ruh_modulate([f], FS_G3, device=dev) for f in frames]
    counts["g3ruh_modulate"] = dict(kernels.LAUNCHES)
    require("g3ruh_modulate", counts["g3ruh_modulate"], ("fir_decimate",))
    call_errs["fir_decimate"] = hold_fir_calls(
        "11 g3ruh", "g3ruh_modulate, the stream and each burst", calls["fir_decimate"])
    del calls
    stream = noisy(clean, G3_NOISE, gen)
    g3_iq = burst_capture(g3_one, int(G3_GAP * FS_G3), G3_GAP_NOISE, gen)
    afsk_iq = burst_capture([afsk_burst(i, hdlc, ops, dev) for i in range(sizes.frames)],
                            int(AFSK_GAP * FS_AFSK), AFSK_GAP_NOISE, gen)
    print(f"[11 captures] G3RUH stream {clean.shape[0]} samples at {FS_G3:.0f} Hz "
          f"(noise {G3_NOISE}), G3RUH bursts {g3_iq.shape[0]}, AFSK bursts "
          f"{afsk_iq.shape[0]} at {FS_AFSK:.0f} Hz, {sizes.frames} corpus frames each")

    # the VCO's phase reaches ~1500 rad here (an f32 step of 1.2e-4): each
    # stream the card makes is held against the same stream with its
    # phase summed, wrapped and turned into sin and cos in float64, at
    # twice the error of the JAX package's arithmetic (an f32 sum, in
    # order, on the host; then the f32 remainder)
    def vco_model(x, k, phase0, f32_sum):
        inc = x * float(np.float32(k))
        if f32_sum:
            ph = torch.cumsum(inc.cpu(), 0).to(x.device) + float(phase0)
            ph = torch.remainder(ph, float(np.float32(2 * math.pi)))
        else:
            ph = torch.remainder(torch.cumsum(inc.double(), 0) + float(phase0),
                                 2 * math.pi)
        return torch.complex(torch.sin(ph), torch.cos(ph)).to(torch.complex64), \
            ph[-1].float()

    refs = {}
    for f32_sum in (False, True):
        with mock.patch.object(ax25, "vco", lambda x, k, phase0=0.0: vco_model(
                x, k, phase0, f32_sum)):
            refs[f32_sum] = torch.view_as_real(ax25.g3ruh_modulate(
                frames, FS_G3, device=dev))
    ref64 = refs[False]
    vco_tol = 2 * max_err(refs[True], ref64)
    report("11 g3ruh", f"g3ruh_modulate {sizes.frames} frames vs its phase in float64 "
           "(tolerance: twice the error of an f32 sum on the host)",
           max_err(torch.view_as_real(clean), ref64), vco_tol)
    del refs

    def path(name, fn, gate, needs, plain=None):
        """Decode with ``fn`` (launches counted) and once on the plain
        versions (unless ``plain`` gives the list to match): the same list,
        and at least ``gate`` frames."""
        zero_counts()
        out = fn()
        counts[name] = dict(kernels.LAUNCHES)
        got = decoded(out, sizes.frames)
        what = "the native form's list" if plain is not None else \
            "the plain versions' list"
        if plain is None:
            with plain_versions():
                plain = decoded(fn(), sizes.frames)
        print(f"[11 {name}] {len(set(got))}/{sizes.frames} decoded, {what}: "
              f"{got == plain}; launches {json.dumps(counts[name])}; card: {card}")
        if len(set(got)) < gate or got != plain:
            failures.append(f"{name}: {len(set(got))} frames, or not the plain "
                            "versions' list")
        require(name, counts[name], needs)
        return [bytes(p) for p in out]

    # the 9600 bd receiver on the stream (the 7227-tap channel filter takes
    # the FFT route: no kernel A; kernel D in the events form).  The events
    # form's list is held to the native form's plain run: kernel D's plain
    # loop over all 300,664 slots of its call took 30-39 s, so it runs on a
    # prefix of them below
    rx = {}
    for method in ("native", "events"):
        rx[method] = path(f"ax25_9600_rx {method}", lambda: ax25.ax25_9600_rx(
            stream, FS_G3, symbol_max_deviation=G3_MAX_DEV, sync=method), sizes.gate,
            ("symbol_sync_events",) if method == "events" else (),
            decoded(rx["native"], sizes.frames) if method == "events" else None)
        n_default = len(set(decoded(ax25.ax25_9600_rx(stream, FS_G3, sync=method),
                                    sizes.frames)))
        print(f"[11 ax25_9600_rx {method}] at the default clock bound 0.1 (taps "
              f"0.0001, 0.99999999 hold the clock at sps + 0.1): {n_default}/{sizes.frames}")
    # kernel D on each of its calls, on the first and last D_WINDOW slots
    # of each channel, against the plain loop on the host
    with capturing("symbol_sync_events_scan") as calls:
        ax25.ax25_9600_rx(stream, FS_G3, symbol_max_deviation=G3_MAX_DEV,
                          sync="events")
    call_errs["symbol_sync_events"] = hold_events_windows(
        "11 ax25_9600_rx", "ax25_9600_rx events",
        calls["symbol_sync_events_scan"])
    rx["wpcr 9600"] = path("ax25_9600_wpcr_rx", lambda: ax25.ax25_9600_wpcr_rx(
        g3_iq, FS_G3, threshold=BURST_THRESHOLD), sizes.gate, ())
    rx["wpcr 1200"] = path("ax25_1200_wpcr_rx", lambda: ax25.ax25_1200_wpcr_rx(
        afsk_iq, FS_AFSK, threshold=BURST_THRESHOLD), sizes.gate, ("fir_decimate",))
    # the 50 kHz front-end's calls: the 1205-tap channel filter (both
    # planes), the Hilbert and the 1205-tap low-pass
    with capturing("fir_decimate") as calls:
        ax25.ax25_1200_wpcr_rx(afsk_iq, FS_AFSK, threshold=BURST_THRESHOLD)
    call_errs["fir_decimate"] = max(call_errs["fir_decimate"], hold_fir_calls(
        "11 ax25_1200_wpcr_rx", "ax25_1200_wpcr_rx", calls["fir_decimate"]))
    del calls
    end_phase("11 receivers")

    # WPCR on the JAX package's corpus: the card against the CPU and the
    # numpy golden model, burst by burst
    bursts, payloads = wpcr_corpus(hdlc, sizes.wpcr_bursts)
    on_card = [torch.from_numpy(b).to(dev) for b in bursts]
    zero_counts()
    res = ops.wpcr_batch(on_card)
    counts["wpcr_batch"] = dict(kernels.LAUNCHES)
    res_cpu = ops.wpcr_batch(bursts, device="cpu")
    centred = [ops.midpoint(torch.from_numpy(b))[0].numpy() for b in bursts]
    golden = [wpcr_numpy(c) for c in centred]
    n_dec, unequal, disagree, moved = 0, [], [], 0
    for i, ((s, info), (cs, cinfo)) in enumerate(zip(res, res_cpu)):
        if info != cinfo or not torch.equal(s.cpu(), cs):
            unequal.append(i)
        m = wpcr_moved(centred[i], s.cpu().numpy(), info, golden[i])
        if m < 0:
            disagree.append(i)
        moved += max(m, 0)
        if info["found"]:
            bits = ops.nrzi_decode(ops.binary_slicer(s))
            pkts, _ = ops.hdlc_deframe(bits, 5, 1500)
            n_dec += any(bytes(np.asarray(d)) == payloads[i] for d, _ in pkts)
    ties = sum(info["near_tie"] for _, info in res)
    print(f"[11 wpcr] wpcr_batch on the WPCR corpus: {n_dec}/{len(bursts)} decoded, "
          f"{sum(i['found'] for _, i in res)} found; bursts unlike the CPU run "
          f"{unequal}, unlike wpcr_numpy {disagree} ({moved} symbols a sample "
          f"away at a phase within 1e-4 of an integer); near-ties {ties}; launches "
          f"{json.dumps(counts['wpcr_batch'])}; card: {card}")
    if n_dec < sizes.wpcr_gate or unequal or disagree:
        failures.append(f"wpcr corpus: {n_dec} decoded, unequal {unequal}, "
                        f"unlike numpy {disagree}")
    end_phase("11 wpcr")

    # the apps on the captures written as c32
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    for name, x in (("g3", stream), ("g3b", g3_iq), ("afsk", afsk_iq)):
        x.cpu().numpy().tofile(d / f"{name}.c32")
    (d / "tx.kiss").write_bytes(b"".join(g3ruh.kiss_encode_frame(f) for f in frames))
    dev_arg = ["--device", str(dev)]

    def app(name, main, args, needs=()):
        """``main(args)`` once, its output to the console kept aside."""
        zero_counts()
        out = io.TextIOWrapper(io.BytesIO())
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            rc = main(args + dev_arg)
        counts[f"app {name}"] = dict(kernels.LAUNCHES)
        if rc != 0:
            failures.append(f"app {name}: exit code {rc}")
        require(f"app {name}", counts[f"app {name}"], needs)
        out.flush()
        return out.buffer.getvalue()

    def written(out_dir):
        return [p.read_bytes() for p in sorted(Path(out_dir).iterdir())]

    def app_line(name, ok, what):
        print(f"[11 apps] {name}: {what}: {ok}; launches "
              f"{json.dumps(counts[f'app {name}'])}; card: {card}")
        if not ok:
            failures.append(f"app {name}: {what}")

    for name, main_fn, args, want, needs in (
            ("ax25_9600_rx", ax25_9600_rx.main,
             ["-r", str(d / "g3.c32"), "--symbol_max_deviation", str(G3_MAX_DEV)],
             rx["native"], ()),
            ("ax25_9600_wpcr", ax25_9600_wpcr.main,
             ["-r", str(d / "g3b.c32"), "--sample_rate", "300k", "--threshold",
              str(BURST_THRESHOLD)], rx["wpcr 9600"], ()),
            ("ax25_1200_wpcr", ax25_1200_wpcr.main,
             ["-r", str(d / "afsk.c32"), "--threshold", str(BURST_THRESHOLD)],
             rx["wpcr 1200"], ("fir_decimate",))):
        app(name, main_fn, args + ["-o", str(d / name)], needs)
        app_line(name, written(d / name) == want,
                 f"-o wrote the model call's {len(want)} frames")
    kiss = app("g3ruh rx", g3ruh.main,
               ["-r", str(d / "g3.c32"), "--symbol_max_deviation",
                str(G3_MAX_DEV), "--symbol_taps", "0.0001,0.99999999"])
    app_line("g3ruh rx", [bytes(f) for f in g3ruh.kiss_decode_stream(kiss)]
             == rx["native"], f"KISS out holds the model call's {len(rx['native'])} frames")
    app("g3ruh tx", g3ruh.main, ["--tx_in", str(d / "tx.kiss"), "--tx_out",
                                 str(d / "tx.c32")], ("fir_decimate",))
    tx = torch.from_numpy(np.fromfile(d / "tx.c32", np.complex64))
    err = (max_err(torch.view_as_real(tx).to(dev), ref64)
           if tx.shape == clean.shape else math.inf)
    app_line("g3ruh tx", err <= vco_tol, f"--tx_in {sizes.frames} KISS frames -> "
             f"--tx_out the G3RUH stream, max |error| {err:.3e} against its phase "
             f"in float64 (tol {vco_tol:.3e})")
    # the burst gate's tail (5000 samples by default) would outlast the
    # 2500-sample gaps at 50 kHz and swallow the next start
    app("burst_saver", burst_saver.main,
        ["-r", str(d / "g3b.c32"), "-o", str(d / "bursts"), "--threshold",
         str(BURST_THRESHOLD), "--delay", "500", "--tail", "500"])
    n_saved = len(list((d / "bursts").iterdir()))
    app_line("burst_saver", n_saved == sizes.frames,
             f"cut {n_saved} bursts of the {sizes.frames} G3RUH bursts")
    tmp.cleanup()
    end_phase("11 apps")

    # the 9600 WPCR receiver's front half from blocks: offline, streamed in
    # chunks of 2^16 (bursts straddle chunks) and paused at a checkpoint
    # inside a burst and resumed; each run's bursts and symbol PDUs against
    # the model's and wpcr_batch's
    lp = tapgen.low_pass_complex(FS_G3, 20_000.0, 100.0, "hamming")

    def run_front(chunk=None, **kw):
        """The front half as a graph, run offline or streamed: (its symbol
        PDUs, the bursts StreamToPdu cut)."""
        g, sink, cut = Graph(), blocks.PduVectorSink(), blocks.PduVectorSink()
        x = g.add(blocks.RationalResampler(int(FS_AFSK), int(FS_G3)),
                  g.add(blocks.FftFilter(lp), g.add(blocks.VectorSource(g3_iq))))
        power = g.add(blocks.SinglePoleIirFilter(0.01),
                      g.add(blocks.ComplexToMag2(), x))
        # cut the power's chunks as the discriminator's (one sample fewer
        # in the first), so that the tagger pairs the samples that the
        # model pairs, streamed as offline
        power = g.add(blocks.Skip(1), g.add(blocks.Delay(1), power))
        tagged = g.add(blocks.BurstTagger(BURST_THRESHOLD),
                       g.add(blocks.QuadratureDemod(1.0), x), power)
        pdus = g.add(blocks.StreamToPdu("burst", 50_000, 50), tagged)
        g.add(cut, pdus)
        g.add(sink, g.add(blocks.Wpcr(), g.add(blocks.Midpointer(), pdus)))
        if chunk:
            g.run_stream(chunk_size=chunk, device=dev, **kw)
        else:
            g.run(device=dev)
        return sink.pdus(), cut.pdus()

    power, demod = ax25._burst_front(g3_iq, FS_G3, FS_AFSK, 20_000.0, 0.01)
    n = min(demod.shape[0], power.shape[0])
    start, end = ops.burst_tagger(power[:n], BURST_THRESHOLD)
    model_bursts = ops.stream_to_pdu(demod[:n], start, end, 50_000, 50)
    model = [(s, info) for s, info in ops.wpcr_batch(model_bursts) if info["found"]]
    edges = list(zip(torch.nonzero(start)[:, 0].tolist(),
                     torch.nonzero(end)[:, 0].tolist()))
    # the first chunk boundary (in the discriminator's samples) inside a burst
    pause = next(k for k in range(1, g3_iq.shape[0] // sizes.burst_chunk)
                 if any(s + 100 < k * sizes.burst_chunk // 6 - 1 < e - 100 for s, e in edges))

    def frames_of(syms):
        out = []
        for s in syms:
            bits = ops.descramble(ops.nrzi_decode(ops.binary_slicer(s)))
            out += [bytes(np.asarray(d)) for d, _ in ops.hdlc_deframe(bits, 10, 1500)[0]]
        return out

    model_frames = frames_of([s for s, _ in model])

    def same_pdus(pdus, ref) -> bool:
        """Symbol PDUs bit-equal to (symbols, info) pairs, sps and phase
        tags included."""
        tags = [{t.key: t.val for t in p.tags} for p in pdus]
        return len(pdus) == len(ref) and all(
            torch.equal(p.data, s) and t["sps"] == info["sps"]
            and t["phase"] == info["phase"] for p, t, (s, info) in zip(pdus, tags, ref))

    def held(label, pdus, cuts, exact):
        """A run against the model: the bursts cut at the model's edges (the
        same count and lengths), the symbol PDUs bit-equal to wpcr_batch
        over the run's own bursts, and the model's frames decoded from
        them; offline (``exact``) the bursts and PDUs are the model's bit
        for bit.  Streamed, the 7227-tap channel filter runs chunk by chunk
        (overlap-save FFTs of other lengths, ~3e-7 apart), and the angle of
        a sample in the noise after a burst (|x| down to ~1e-7) turns on
        those bits: the samples there differ, and WPCR's clock with them."""
        cut_ok = len(cuts) == len(model_bursts) and all(
            c.data.shape == m.shape for c, m in zip(cuts, model_bursts))
        cut_err = max((max_err(c.data, m) for c, m in zip(cuts, model_bursts)),
                      default=0.0) if cut_ok else math.inf
        own = [(s, info) for s, info in ops.wpcr_batch([c.data for c in cuts])
               if info["found"]]
        own_equal = same_pdus(pdus, own)
        model_equal = same_pdus(pdus, model)
        frames_equal = frames_of([p.data for p in pdus]) == model_frames
        print(f"[11 block graph] {label}: {len(cuts)} bursts cut at the model's "
              f"edges: {cut_ok}, samples max |error| {cut_err:.3e}; {len(pdus)} "
              f"symbol PDUs, bit-equal to wpcr_batch over these bursts: "
              f"{own_equal}, to the model's: {model_equal}; the model's "
              f"{len(model_frames)} frames decoded from them: {frames_equal}")
        if not (cut_ok and own_equal and frames_equal) or (
                exact and not (cut_err == 0.0 and model_equal)):
            failures.append(f"block graph {label}: not the model's bursts and PDUs")

    for label, chunk in (("offline", None), (f"streamed (chunks of {sizes.burst_chunk})",
                                             sizes.burst_chunk)):
        zero_counts()
        pdus, cuts = run_front(chunk)
        counts[f"graph {label}"] = dict(kernels.LAUNCHES)
        held(label, pdus, cuts, chunk is None)
        print(f"[11 block graph] {label}: launches "
              f"{json.dumps(counts[f'graph {label}'])}; card: {card}")
    with tempfile.TemporaryDirectory() as ck_dir:
        ck = str(Path(ck_dir) / "burst.pkl")
        first, first_cuts = run_front(sizes.burst_chunk, max_chunks=pause,
                                      checkpoint_path=ck, checkpoint_every=pause)
        states = load_checkpoint(ck, device=dev)[0]
        modes = [s["mode"] for s in states.values()
                 if isinstance(s, dict) and "mode" in s]
        rest, rest_cuts = run_front(sizes.burst_chunk, resume_from=ck)
    resumed_equal = (len(first) + len(rest) == len(pdus) and all(
        torch.equal(p.data, q.data) for p, q in zip(first + rest, pdus)))
    print(f"[11 block graph] paused after {pause} chunks with a burst open "
          f"(StreamToPdu mode {modes}: 1 is Packet), {len(first)} PDUs, resumed "
          f"({len(rest)} PDUs): the uninterrupted streamed PDUs bit for bit: "
          f"{resumed_equal}")
    if modes != [blocks.StreamToPdu.PACKET] or not resumed_equal:
        failures.append("block graph: not paused inside a burst, or the resumed "
                        "stream is not the uninterrupted one")
    held("paused and resumed", first + rest, first_cuts + rest_cuts, False)
    end_phase("11 block graph")
    return counts, call_errs


# ---- phase 12: the radio-facing receivers

APP_TAPS = (0.5, 0.5)      # ax25_1200_rx's and il2p_1200_rx's clock taps
FS_BELL = 44_100.0         # bell202_tx's default rate
IL2P_FS = 50_000.0         # il2p_1200_rx's default rate
IL2P_GAP = 800             # seeded random bits before each IL2P frame
IL2P_NOISE = 0.05          # complex noise per component; carrier 1.0
IL2P_CHUNK = 1 << 12       # run_stream's chunk for the IL2P blocks
FS_SCAN = 2_048_000.0      # scanner -r sim: an rtl-sdr rate,
SCAN_CHANNELS = 256        # 8 kHz channels
SIM_TONE = 1_000.0         # the simulated carriers' audio tone
# IL2P header types by frame: (ui, pid, control, hdrtype1) and describe()
IL2P_TYPES = (((False, 1, 1 << 2, True), "SABM"), ((True, 15, 0, True), "UI"),
              ((False, 1, 3 << 2, True), "DISC"),
              ((False, 5, 0x55, False), "type0 IL2P"),
              ((False, 6, 0x7F, True), "other PID"))


@dataclasses.dataclass(frozen=True)
class RadioSizes:
    """Phase 12's sizes: the defaults on the card; a CPU rehearsal
    (``tests/test_torch_chip_smoke.py``) takes small ones."""

    frames: int = N_FRAMES          # corpus frames of the audio given
    frame_gate: int = FRAME_GATE
    iq_frames: int = N_IQ_FRAMES    # corpus frames of the IQ capture given
    iq_gate: int = IQ_FLOOR
    bell_lines: int = 200
    il2p_frames: int = 200          # ~8 M samples at 50 kHz
    il2p_chunk: int = IL2P_CHUNK    # run_stream's chunk for the IL2P blocks
    il2p_gap: int = IL2P_GAP        # random bits before each IL2P frame
    sim_samples: int = 1 << 24      # rtl_fm -r sim, soapy_fm -d sim
    scan_samples: int = 1 << 20     # scanner -r sim


def il2p_fields(i: int):
    """Frame i's header: (dst, dst ssid, src, src ssid, ui, pid, control,
    hdrtype1, payload size), and its ``describe()``."""
    (ui, pid, control, t1), name = IL2P_TYPES[i % len(IL2P_TYPES)]
    return (f"Q{i % 1000:03d}", i % 16, f"N{i % 10}X{i // 10 % 100:02d}",
            (i // 16) % 16, ui, pid, control, t1, (37 * i) % 1024), name


def il2p_header_bytes(dst, dssid, src, sssid, ui, pid, control, hdrtype1, size):
    """The 13 bytes that ``ops.il2p.parse_header`` reads back as these
    fields (FEC flag set): the inverse of the parse."""
    d = [0] * 13
    for k, c in enumerate(dst):
        d[k] = (ord(c) - 0x20) & 63
    for k, c in enumerate(src):
        d[6 + k] = (ord(c) - 0x20) & 63
    d[0] |= 0x80 | (0x40 if ui else 0)
    d[1] |= 0x80 if hdrtype1 else 0
    for k in range(4):
        d[1 + k] |= ((pid >> (3 - k)) & 1) << 6
    for k in range(7):
        d[5 + k] |= ((control >> (6 - k)) & 1) << 6
    for k in range(10):
        d[2 + k] |= ((size >> (9 - k)) & 1) << 7
    d[12] = (dssid << 4) | sssid
    return np.asarray(d, np.uint8)


def il2p_scramble(bits, mask: int = 0x108, seed: int = 0x1F0) -> np.ndarray:
    """The inverse of ``ops.il2p.il2p_descramble``: i = o ^ (reg & 1), then
    the descrambler's register update on i."""
    reg, out = seed, np.empty(len(bits), np.uint8)
    for n, o in enumerate(bits):
        i = int(o) ^ (reg & 1)
        out[n] = i
        reg = (reg >> 1) ^ (mask * i)
    return out


def il2p_frame(fields, fec) -> np.ndarray:
    """One IL2P frame's 144 bits: the sync word 0xF15E48, then the header
    of ``fields`` (``il2p_header_bytes``'s arguments) and the two bytes
    ``fec``, MSB first, scrambled."""
    from rustradio_tpu_torch.ops.il2p import SYNC_WORD

    raw = np.concatenate([il2p_header_bytes(*fields), np.asarray(fec, np.uint8)])
    return np.concatenate([SYNC_WORD, il2p_scramble(np.unpackbits(raw))])


def il2p_bits(n_frames: int, seed: int, gap: int = IL2P_GAP):
    """``n_frames`` IL2P frames (``il2p_frame`` of ``il2p_fields``), each
    after ``gap`` seeded random bits, and the gap again at the end.
    Returns the bits, each sync word's last position and each header's
    (src, dst, type)."""
    from rustradio_tpu_torch.ops.il2p import SYNC_WORD

    rng = np.random.RandomState(seed)
    parts, ends, want, pos = [], [], [], 0
    for i in range(n_frames):
        fields, name = il2p_fields(i)
        frame = il2p_frame(fields, (i % 256, 0xA5))
        parts += [rng.randint(0, 2, gap).astype(np.uint8), frame]
        ends.append(pos + gap + len(SYNC_WORD) - 1)
        pos += gap + len(frame)
        want.append((f"{fields[2]}-{fields[3]}", f"{fields[0]}-{fields[1]}", name))
    parts.append(rng.randint(0, 2, gap).astype(np.uint8))
    return np.concatenate(parts), ends, want


def il2p_capture(bits: np.ndarray, seed: int, noise: float = IL2P_NOISE,
                 fs: float = IL2P_FS) -> np.ndarray:
    """The bits as Bell-202 AFSK at ``fs`` (bit 1 -> 1200 Hz: the receiver
    slices and inverts), 0.3 of it frequency-modulating a carrier at 3.5
    kHz a unit, as tests/test_models_extra.py:65-90; 2000 samples of
    silence around it and complex noise of ``noise`` per component (numpy
    RandomState of ``seed``)."""
    sps = fs / 1200.0
    n = int(len(bits) * sps)
    at = np.minimum((np.arange(n) / sps).astype(np.int64), len(bits) - 1)
    f = np.where(bits[at] == 1, 1200.0, 2200.0)
    audio = 0.5 * np.sin(np.cumsum(2 * np.pi * f / fs))
    audio = np.concatenate([np.zeros(2000), audio, np.zeros(2000)])
    ph = np.cumsum(0.3 * audio * (2 * np.pi * 3500.0 / fs))
    rnd = np.random.RandomState(seed).standard_normal((2, len(ph)))
    return (np.exp(1j * ph) + noise * (rnd[0] + 1j * rnd[1])).astype(np.complex64)


def radio_phase(dev, card: str, sizes: RadioSizes, audio: np.ndarray,
                iq_np: np.ndarray):
    """Phase 12: the radio-facing receivers through their apps at full
    width on ``dev``: ``ax25_1200_rx`` on the corpus as .au (both clock
    recoveries) and on the IQ capture as raw c32 and as SigMF written by
    ``capture``, each against the model call with the app's taps;
    ``bell202_tx`` into ``ax25_1200_rx``; an IL2P capture through
    ``il2p_1200_rx`` (model, plain versions, app) and its bits through the
    blocks ``CorrelateAccessCodeTag`` and ``Il2pDeframer`` offline and
    streamed with headers across chunk seams; ``rtl_fm -r sim`` and
    ``soapy_fm -d sim`` (2^24 samples) and ``scanner -r sim`` on the
    simulated SDR.  Kernel A is held against its plain version on each of
    its calls, kernels D and E on each of the apps' calls (on windows of
    them, ``hold_events_windows`` and ``hold_scan_calls``).  ``audio`` is
    the corpus of ``sizes.frames`` frames at FS_AUDIO, ``iq_np`` the IQ
    capture of ``sizes.iq_frames`` at FS_IQ.  Returns the launch counts of
    each path and the largest |error| of each kernel here."""
    import io
    import tempfile
    from pathlib import Path

    from rustradio_tpu_torch import blocks, ops, taps as tapgen
    from rustradio_tpu_torch.apps import (ax25_1200_rx, bell202_tx, capture,
                                          il2p_1200_rx, rtl_fm, scanner,
                                          soapy_fm)
    from rustradio_tpu_torch.graph import Graph
    from rustradio_tpu_torch.hw import SdrSource, SimDriver
    from rustradio_tpu_torch.io import au
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import kernels
    from rustradio_tpu_torch.ops.il2p import SYNC_WORD

    counts = {}
    errs = {"fir_decimate": 0.0, "symbol_sync_events": 0.0,
            "symbol_sync_scan": 0.0}
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    wrappers = ("fir_decimate", "symbol_sync_events_scan", "symbol_sync_scan")

    def hold(phase, what, calls):
        """Each kernel on each of its captured calls ``calls``."""
        for wrapper, key, fn in (
                ("fir_decimate", "fir_decimate", hold_fir_calls),
                ("symbol_sync_events_scan", "symbol_sync_events",
                 hold_events_windows),
                ("symbol_sync_scan", "symbol_sync_scan", hold_scan_calls)):
            if calls.get(wrapper):
                errs[key] = max(errs[key], fn(phase, what, calls[wrapper]))

    def held(phase, what, fn):
        """``fn()``, kernel A held on each of its calls there."""
        with capturing("fir_decimate") as calls:
            out = fn()
        hold(phase, what, calls)
        return out

    def app(phase, name, main_fn, args, needs=(), stdin="", device=True):
        """``main_fn(args)`` (on ``dev`` unless ``device`` is False): its
        launches counted and each kernel held on each of its calls.
        Returns its standard output."""
        zero_counts()
        out = io.StringIO()
        with capturing(*wrappers) as calls, contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()), \
                mock.patch("sys.stdin", io.StringIO(stdin)):
            rc = main_fn(args + (["--device", str(dev)] if device else []))
        if rc != 0:
            failures.append(f"app {name}: exit code {rc}")
        counts[name] = dict(kernels.LAUNCHES)
        require(name, counts[name], needs)
        hold(phase, name, calls)
        return out.getvalue()

    def written(out_dir):
        return [p.read_bytes() for p in sorted(Path(out_dir).iterdir())]

    def check(phase, what, ok, line):
        print(f"[{phase}] {what}: {ok}; {line}; card: {card}")
        if not ok:
            failures.append(f"{phase} {what}")

    # the corpus as .au, both clock recoveries, against the model's list
    (d / "corpus.au").write_bytes(au.au_encode(audio, int(FS_AUDIO)))
    pcm = torch.from_numpy(au.au_read(str(d / "corpus.au"))[0]).to(dev)
    for sync_m in ("native", "events"):
        name = f"ax25_1200_rx au {sync_m}"
        want = decoded(held("12 ax25", f"ax25_1200_rx {sync_m}", lambda:
                            ax25.ax25_1200_rx(pcm, FS_AUDIO, symbol_taps=APP_TAPS,
                                              sync=sync_m)), sizes.frames)
        app("12 ax25", name, ax25_1200_rx.main,
            ["-a", "-r", str(d / "corpus.au"), "-o", str(d / name), "--sync", sync_m],
            ("fir_decimate", "symbol_sync_events") if sync_m == "events"
            else ("fir_decimate",))
        got = decoded(written(d / name), sizes.frames)
        check("12 ax25", f"{name}: {len(set(got))}/{sizes.frames} decoded (gate "
              f"{sizes.frame_gate}), the model's list with taps {APP_TAPS}",
              len(set(got)) >= sizes.frame_gate and got == want,
              f"launches {json.dumps(counts[name])}")
    del pcm
    end_phase("12 ax25 au")

    # the IQ capture as raw c32, then as SigMF written by the capture app
    iq_np.tofile(d / "iq.c32")
    app("12 ax25", "capture", capture.main,
        ["-r", str(d / "iq.c32"), "--sample_rate", str(FS_IQ),
         "--frequency", "144.39m", "--out", str(d / "iq")], device=False)
    want = decoded(held("12 ax25", "ax25_1200_rx_iq", lambda: ax25.ax25_1200_rx_iq(
        iq_np, FS_IQ, device=dev, symbol_taps=APP_TAPS)), sizes.iq_frames)
    lists = []
    for form, args in (("c32", ["-r", str(d / "iq.c32"), "--sample_rate", "1.024m"]),
                       ("SigMF", ["-r", str(d / "iq.sigmf-meta")])):
        name = f"ax25_1200_rx {form}"
        app("12 ax25", name, ax25_1200_rx.main, args + ["-o", str(d / name)],
            ("fir_decimate",))
        lists.append(decoded(written(d / name), sizes.iq_frames))
        check("12 ax25", f"{name}: {len(set(lists[-1]))}/{sizes.iq_frames} "
              f"decoded (gate {sizes.iq_gate}), the model's list",
              len(set(lists[-1])) >= sizes.iq_gate and lists[-1] == want,
              f"launches {json.dumps(counts[name])}")
    check("12 ax25", "raw c32 and SigMF give the same list", lists[0] == lists[1],
          f"{len(lists[0])} frames")
    (d / "iq.c32").unlink()
    (d / "iq.sigmf-data").unlink()

    # bell202_tx -> ax25_1200_rx at 44.1 kHz
    lines = [f"CHIP SMOKE BELL-202 LINE {i:03d} {'z' * (i % 37)}"
             for i in range(sizes.bell_lines)]
    app("12 bell202", "bell202_tx", bell202_tx.main,
        ["--src", "N0CALL-7", "--dst", "APRS", "--out", str(d / "bell.au")],
        stdin="\n".join(lines) + "\n")
    app("12 bell202", "ax25_1200_rx bell202", ax25_1200_rx.main,
        ["-a", "-r", str(d / "bell.au"), "-o", str(d / "bell")], ("fir_decimate",))
    got = written(d / "bell")
    sent = [bytes(bell202_tx.make_ax25_ui("APRS", "N0CALL-7", s.encode()))
            for s in lines]
    check("12 bell202", f"bell202_tx {len(lines)} lines at {FS_BELL:.0f} Hz -> "
          f"ax25_1200_rx: {len(got)}/{len(lines)} decoded, the frames sent",
          got == sent, f"launches tx {json.dumps(counts['bell202_tx'])}, rx "
          f"{json.dumps(counts['ax25_1200_rx bell202'])}")
    end_phase("12 ax25 iq and bell202")

    # IL2P: the capture through the model (kernels, plain versions), the app
    bits, ends, want = il2p_bits(sizes.il2p_frames, SEED + 12, sizes.il2p_gap)
    il2p_iq = il2p_capture(bits, SEED + 12)
    print(f"[12 il2p] {sizes.il2p_frames} IL2P frames, {len(bits)} bits, "
          f"{il2p_iq.shape[0]} samples at {IL2P_FS:.0f} Hz (noise {IL2P_NOISE})")
    x = torch.from_numpy(il2p_iq).to(dev)

    def headers(hs):
        return [(h.src, h.dst, h.describe()) for h in hs]

    zero_counts()
    got = headers(ax25.il2p_1200_rx(x, IL2P_FS))
    counts["il2p_1200_rx"] = dict(kernels.LAUNCHES)
    require("il2p_1200_rx", counts["il2p_1200_rx"], ("fir_decimate",))
    held("12 il2p", "il2p_1200_rx", lambda: ax25.il2p_1200_rx(x, IL2P_FS))
    with plain_versions():
        plain = headers(ax25.il2p_1200_rx(x, IL2P_FS))
    check("12 il2p", f"il2p_1200_rx: {len(got)}/{len(want)} headers (src, dst, "
          "type) as sent, the plain versions' list", got == want and plain == got,
          f"launches {json.dumps(counts['il2p_1200_rx'])}")
    il2p_iq.tofile(d / "il2p.c32")
    del x, il2p_iq
    out = app("12 il2p", "il2p_1200_rx app", il2p_1200_rx.main,
              ["-r", str(d / "il2p.c32")], ("fir_decimate",))
    check("12 il2p", "il2p_1200_rx app: the types of the headers sent",
          out.splitlines() == [t for _, _, t in want],
          f"launches {json.dumps(counts['il2p_1200_rx app'])}")

    # the IL2P bits through the blocks, offline and streamed in chunks of
    # IL2P_CHUNK: the sync tags and the headers equal the op's, seams or not
    bits_dev = torch.from_numpy(bits).to(dev)

    def il2p_graph(chunk):
        g, tags, pdus = Graph(), blocks.VectorSink(), blocks.PduVectorSink()
        tagged = g.add(blocks.CorrelateAccessCodeTag(SYNC_WORD),
                       g.add(blocks.VectorSource(bits_dev)))
        g.add(tags, tagged)
        dfr = blocks.Il2pDeframer()
        g.add(pdus, g.add(dfr, tagged))
        if chunk:
            g.run_stream(chunk_size=chunk, device=dev)
        else:
            g.run(device=dev)
        return ([t.pos for t in tags.tags() if t.key == "sync"], headers(dfr.headers),
                [[t.val for t in p.tags] for p in pdus.pdus()])

    op = np.flatnonzero(ops.correlate_access_code(bits_dev, SYNC_WORD).cpu().numpy())
    chunk_n = sizes.il2p_chunk
    seams = sum((e - 23) // chunk_n != (e + 120) // chunk_n for e in ends)
    for label, chunk in (("offline", None), (f"streamed ({chunk_n})", chunk_n)):
        pos, hs, pdu_tags = il2p_graph(chunk)
        check("12 il2p blocks", f"{label}: {len(pos)} sync tags at the op's "
              f"positions, {len(hs)} headers as sent, one PDU each",
              list(pos) == list(op) == ends and hs == want and seams > 0
              and pdu_tags == [list(h) for h in want], f"{seams} headers across "
              "a seam")
    end_phase("12 il2p")

    # rtl_fm -r sim: the simulated carrier (0.8, 1 kHz at 37.5 kHz deviation)
    # at 1.024 Msps, against the same main() on the plain versions
    secs_arg = repr(sizes.sim_samples / FS_RTL)
    n = int(float(secs_arg) * FS_RTL)
    gain = FS_RTL / (2 * np.pi * 75_000.0)
    lp = tapgen.low_pass_complex(FS_RTL, 100_000.0, 50_000.0, "hamming")
    sim = SdrSource(SimDriver(frequency=100e6, sample_rate=FS_RTL, gain=1.0,
                              fm_tones=[(100e6, 0.8, SIM_TONE, 37_500.0)]))
    with plain_versions():
        y_ratio = envelope_ratio(ops.filter_complex(sim.emit(0, n, dev), lp), len(lp))
    args = ["-r", "sim", "--seconds", secs_arg]
    app("12 sdr", "rtl_fm sim", rtl_fm.main, args + ["--out", str(d / "sim.au")],
        ("fir_decimate",))
    with plain_versions(), contextlib.redirect_stderr(io.StringIO()):
        rtl_fm.main(args + ["--out", str(d / "sim_plain.au"), "--device", str(dev)])
    got, want_a = (au.au_read(str(d / f))[0] for f in ("sim.au", "sim_plain.au"))
    err = (float(np.abs(got[3:] - want_a[3:]).max()) if got.shape == want_a.shape
           else math.inf)
    report("12 sdr", f"rtl_fm -r sim {n} samples: .au audio vs the plain versions",
           err, 2 * 2e-5 * y_ratio * gain + 2 * PCM)
    amps, resid = tone_fit(got, AUDIO_RATE, ((SIM_TONE, 0.5),))
    check("12 sdr", f"rtl_fm -r sim: the {SIM_TONE:.0f} Hz tone at "
          f"{amps[0]:.4f} (sent 0.5), residual {resid:.4f}",
          len(got) == -(-n * 3 // 64) and abs(amps[0] / 0.5 - 1) < 0.05
          and resid < 0.25, f"launches {json.dumps(counts['rtl_fm sim'])}")

    # soapy_fm -d sim: a carrier at 75 kHz deviation through wbfm_rx
    app("12 sdr", "soapy_fm sim", soapy_fm.main,
        ["-d", "sim", "--seconds", secs_arg, "-o", str(d / "soapy.au")],
        ("fir_decimate",))
    got = au.au_read(str(d / "soapy.au"))[0]
    sent = deemphasis_gain(SIM_TONE, AUDIO_RATE)
    amps, resid = tone_fit(got, AUDIO_RATE, ((SIM_TONE, sent),))
    check("12 sdr", f"soapy_fm -d sim: the {SIM_TONE:.0f} Hz tone at "
          f"{amps[0]:.4f} (sent, de-emphasized {sent:.4f}), residual {resid:.4f}",
          abs(amps[0] / sent - 1) < 0.05 and resid < 0.25,
          f"launches {json.dumps(counts['soapy_fm sim'])}")

    # scanner -r sim: its two default tones, +0.2 and -0.35 MHz; and the
    # decode bank over the same band (CW carries no packet)
    scan_args = ["-r", "sim", "--sample_rate", str(FS_SCAN), "--seconds",
                 repr(sizes.scan_samples / FS_SCAN)]
    out = app("12 sdr", "scanner sim", scanner.main,
              scan_args + ["-n", str(SCAN_CHANNELS), "--top", "2"])
    rows = [r.split()[:2] for r in out.splitlines()[1:]]
    width = FS_SCAN / SCAN_CHANNELS
    want_rows = [[str(round(f / width) % SCAN_CHANNELS),
                  f"{round(f / width) * width / 1e3:.1f}k"] for f in (0.2e6, -0.35e6)]
    check("12 sdr", f"scanner -r sim: the strongest channels {rows} at the tones' "
          f"offsets {want_rows}", rows == want_rows,
          f"launches {json.dumps(counts['scanner sim'])}")
    app("12 sdr", "scanner sim decode", scanner.main,
        scan_args + ["-n", "64", "--decode"], ("fir_decimate", "symbol_sync_scan"))
    print(f"[12 sdr] scanner -r sim --decode (64 channels): launches "
          f"{json.dumps(counts['scanner sim decode'])}; card: {card}")
    tmp.cleanup()
    end_phase("12 sdr")
    return counts, errs


# ---- phase 13: the batched streaming runner, the Graph's trace and costs,
# and the generators

SCAN_TAPS_DECI = 4        # the FM chain's FirFilter decimation (kernel B)
SCAN_GAIN = 0.5           # its MultiplyConst


@dataclasses.dataclass(frozen=True)
class ScanSizes:
    """Phase 13's sizes: the defaults on the card; a CPU rehearsal
    (``tests/test_torch_chip_smoke.py``) takes small ones."""

    chunk: int = 1 << 20            # the FM chain stream (benches/bench_kernels.py:331-420)
    chunks: int = 64
    scans: tuple = (64, 24)         # scan_chunks: one batch, and a remainder
    ax_chunk: int = 1 << 18         # ax25_1200_rx_graph's stream
    ax_scan: int = 16
    frames: int = N_FRAMES          # corpus frames of the audio given
    frame_gate: int = FRAME_GATE
    block_chunk: int = 1 << 16      # each capturable block alone: 1 + 3 x 4 chunks
    tone_n: int = 1 << 24           # tone's samples
    fm_seconds: float = 10.0        # fm_tx's audio


def capturable_cases(blocks, rng):
    """Every block class that declares ``graph_capturable``, as
    (name, block factory, its inputs as numpy arrays of ``n`` samples,
    outputs): the cases ``scan_phase`` and tests/test_torch_cuda.py run
    alone over three batches."""
    lp = np.real(np.asarray(_low_pass_49())).astype(np.float32)

    def f32(n):
        return [rng.randn(n).astype(np.float32)]

    def c64(n):
        return [(rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)]

    def u8(n):
        return [rng.randint(0, 256, n).astype(np.uint8)]

    return [
        ("Add", lambda: blocks.Add(), lambda n: f32(n) + f32(n), 1),
        ("AddConst", lambda: blocks.AddConst(0.25), f32, 1),
        ("BinarySlicer", lambda: blocks.BinarySlicer(), f32, 1),
        ("ComplexToFloat", lambda: blocks.ComplexToFloat(), c64, 2),
        ("ComplexToMag2", lambda: blocks.ComplexToMag2(), c64, 1),
        ("ComplexToReal", lambda: blocks.ComplexToReal(), c64, 1),
        ("FastFM", lambda: blocks.FastFM(), c64, 1),
        ("FftFilter", lambda: blocks.FftFilter(lp.astype(np.complex64)), c64, 1),
        ("FftFilterFloat", lambda: blocks.FftFilterFloat(lp), f32, 1),
        ("FftStream", lambda: blocks.FftStream(1024), c64, 1),
        ("FirFilter", lambda: blocks.FirFilter(lp, deci=4), c64, 1),
        ("FloatToComplex", lambda: blocks.FloatToComplex(),
         lambda n: f32(n) + f32(n), 1),
        ("Hilbert", lambda: blocks.Hilbert(65), f32, 1),
        ("MultiplyConst", lambda: blocks.MultiplyConst(0.5), c64, 1),
        ("QuadratureDemod", lambda: blocks.QuadratureDemod(0.7), c64, 1),
        ("RtlSdrDecode", lambda: blocks.RtlSdrDecode(), u8, 1),
        ("RtlSdrEncode", lambda: blocks.RtlSdrEncode(), c64, 1),
        ("Tee", lambda: blocks.Tee(), f32, 2),
        ("Vco", lambda: blocks.Vco(0.1), f32, 1),
        ("Xor", lambda: blocks.Xor(), lambda n: u8(n) + u8(n), 1),
        ("XorConst", lambda: blocks.XorConst(0x5A), u8, 1),
    ]


def _low_pass_49():
    from rustradio_tpu_torch import taps as tapgen
    return tapgen.low_pass_complex(1_024_000.0, 100_000.0, 50_000.0, "hamming")


def run_capturable_case(dev, make, inputs, n_out, chunk, scan):
    """One capturable block alone between vector sources and sinks,
    streamed on ``dev`` in chunks of ``chunk`` (``scan_chunks=scan``).
    Returns (each output's samples, the graph)."""
    from rustradio_tpu_torch import blocks
    from rustradio_tpu_torch.graph import Graph

    g = Graph()
    srcs = [g.add(blocks.VectorSource(torch.from_numpy(x).to(dev))) for x in inputs]
    node = g.add(make(), *srcs)
    sinks = [g.add(blocks.VectorSink(), node[k]) for k in range(n_out)]
    g.run_stream(chunk_size=chunk, device=dev, scan_chunks=scan)
    return [s.block.data() for s in sinks], g


def scan_phase(dev, card: str, sizes: ScanSizes, i_main, q_main,
               audio: np.ndarray, want_lists):
    """Phase 13: ``Graph.run_stream(scan_chunks=)`` at full width on
    ``dev``.  The FM chain (VectorSource -> FirFilter 49 taps deci 4 ->
    QuadratureDemod -> MultiplyConst -> sink, the FM pair on kernel B) over
    ``sizes.chunks`` chunks of ``sizes.chunk`` of an ``rtl_fm_iq`` capture,
    with a VectorSink and in a device-resident form (``emit_batch`` and
    ``accept_batch``), per chunk and batched: each batch one replay,
    kernel B's launches the chunks, the output bit-equal to the per-chunk
    run and within kernel B's budget of the plain versions, a second run
    replaying the first run's captures, a traced run (``profile_dir``),
    ``generate_stats()``;
    ``ax25_1200_rx_graph`` on the corpus batched, both sync methods, with
    kernel A held on the segment's outputs and kernel D on its calls; every
    capturable block class alone over three batches; and the generator
    apps (``tone``, ``fm_tx`` into ``rtl_fm``, ``spectrum``,
    ``morse_beacon``, ``pw_tone``).  Returns the launch counts of each path
    and the largest |error| of each kernel held here."""
    import io
    import tempfile
    from pathlib import Path

    from rustradio_tpu_torch import blocks
    from rustradio_tpu_torch.apps import (fm_tx, morse_beacon, pw_tone, rtl_fm,
                                          spectrum, tone)
    from rustradio_tpu_torch.graph import Graph
    from rustradio_tpu_torch.io import au, rawfile
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import kernels
    from rustradio_tpu_torch.utils import stats
    from rustradio_tpu_torch.utils.waterfall import spectrogram

    on_card = dev.type == "cuda"
    counts = {}
    errs = {"fm_chain": 0.0, "fir_decimate": 0.0, "symbol_sync_events": 0.0}
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)

    # ---- the FM chain stream
    n = sizes.chunk * sizes.chunks
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    si, sq, _ = rtl_fm_iq(n, dev, gen)
    x_dev = torch.complex(si, sq)
    x_host = x_dev.cpu().numpy()
    del si, sq
    lpr = np.real(np.asarray(_low_pass_49())).astype(np.float32)

    def fm_graph(form):
        g = Graph()
        sink = blocks.VectorSink() if form == "host" else batch_sink()
        g.chain(blocks.VectorSource(x_host if form == "host" else x_dev),
                blocks.FirFilter(lpr, deci=SCAN_TAPS_DECI),
                blocks.QuadratureDemod(1.0), blocks.MultiplyConst(SCAN_GAIN), sink)
        return g, sink

    def out_of(sink):
        return (torch.from_numpy(sink.data()).to(dev) if isinstance(sink, blocks.VectorSink)
                else sink.data())

    def batches(scan):
        """The batch sizes the runner takes after the first chunk."""
        left, out = sizes.chunks - 1, []
        while scan and left >= 2:
            out.append(min(scan, left))
            left -= out[-1]
        return out

    ref = None
    for form in ("host", "device"):
        for scan in (None,) + tuple(sizes.scans):
            label = f"fm chain {form} scan_chunks={scan}"
            g, sink = fm_graph(form)
            zero_counts()
            g.run_stream(chunk_size=sizes.chunk, device=dev, scan_chunks=scan)
            counts[label] = dict(kernels.LAUNCHES)
            got = out_of(sink)
            if ref is None:
                ref = got
                with plain_versions():
                    pg, psink = fm_graph(form)
                    pg.run_stream(chunk_size=sizes.chunk, device=dev)
                plain = out_of(psink)
                errs["fm_chain"] = max(errs["fm_chain"], report(
                    "13 fm stream", f"{label} vs the plain versions per chunk",
                    max_err(got, plain), BUDGET["highest"]))
                del plain, pg, psink
            equal = got.shape == ref.shape and bool(torch.equal(got, ref))
            sink.__init__()  # a second run replays the first run's captures
            g.run_stream(chunk_size=sizes.chunk, device=dev, scan_chunks=scan)
            caps = [(e["unit"], e["nb"], e["replays"], e["warm_up"], e["recorded"])
                    for e in g.capture_log]
            print(f"[13 fm stream] {label}: {sizes.chunks} chunks of {sizes.chunk}, "
                  f"bit-equal to the per-chunk card run: {equal}; launches "
                  f"{json.dumps(counts[label])}; captured (unit, nb, replays over "
                  f"the 2 runs, warm-up launches, recorded launches): {caps}; "
                  f"card: {card}")
            if not equal:
                failures.append(f"{label}: not the per-chunk card run")
            nbs = batches(scan)
            if on_card:
                if counts[label]["fm_chain"] != sizes.chunks:
                    failures.append(f"{label}: kernel B launched "
                                    f"{counts[label]['fm_chain']} times for "
                                    f"{sizes.chunks} chunks")
                want_caps = sorted({(nb, nbs.count(nb) * 2) for nb in nbs})
                if sorted((c[1], c[2]) for c in caps) != want_caps:
                    failures.append(f"{label}: captures {caps}, want (nb, "
                                    f"replays) {want_caps}")
            require(label, counts[label], ("fm_chain",))
            del g, sink, got
    # a traced run of each (profile_dir), read by utils.stats
    for scan in (None,) + tuple(sizes.scans):
        g, sink = fm_graph("device")  # one warm run (and its captures), then
        g.run_stream(chunk_size=sizes.chunk, device=dev, scan_chunks=scan)
        sink.__init__()  # the traced one
        g.run_stream(chunk_size=sizes.chunk, device=dev, scan_chunks=scan,
                     profile_dir=str(d / f"trace_{scan}"))
        n_dev = stats.device_busy_share(g.trace_path)[2]
        print(f"[13 fm stream] traced run, device form, scan_chunks={scan}: "
              + (f"the trace held {n_dev} device events" if n_dev else
                 "the trace held no device events") + f"; card: {card}")
        # the stats table: a row for each block, then the total; the costs'
        # columns (kernel B's work from its launches and replays)
        table = g.generate_stats().splitlines()
        names = [row.split()[0] for row in table[1:]]
        want_names = [nd.block.name() for nd in g.nodes] + ["TOTAL"]
        print(f"[13 fm stream] generate_stats() over the warm run and the "
              f"traced one, scan_chunks={scan}: columns {table[0].split()}, "
              f"rows {names}; card: {card}")
        if names != want_names or "GFLOP" not in table[0]:
            failures.append(f"13 fm stream scan_chunks={scan}: generate_stats() "
                            f"rows {names}, want {want_names} with costs")
        del g, sink
    del ref, x_dev, x_host
    end_phase("13 fm stream")

    # ---- the AX.25 receiver built from blocks, batched
    audio = torch.as_tensor(audio).to(dev)
    real_run = Graph.run_stream
    real_apply = blocks.SymbolSync.apply_chunk
    inputs = {}

    def keep(label):
        """SymbolSync's chunk form, keeping each chunk it is given: the
        front-end segment's outputs."""
        def apply_chunk(self, state, x):
            inputs.setdefault(label, []).append(x.clone())
            return real_apply(self, state, x)
        return apply_chunk

    def receive(label, scan, sync_method):
        with mock.patch.object(blocks.SymbolSync, "apply_chunk", keep(label)):
            return ax25.ax25_1200_rx_graph(
                audio, FS_AUDIO, chunk_size=sizes.ax_chunk, scan_chunks=scan,
                sync=sync_method)

    # the plain versions' front-end, once: the segment is the same for both
    # sync methods (a plain kernel D would loop over every slot in Python)
    with plain_versions():
        receive("plain", None, "native")
    for sync_method, want in want_lists.items():
        graphs = []

        def run_stream(self, *a, **kw):
            graphs.append(self)
            return real_run(self, *a, **kw)

        label = f"ax25 graph {sync_method} scan_chunks={sizes.ax_scan}"
        zero_counts()
        with mock.patch.object(Graph, "run_stream", run_stream), \
                capturing("symbol_sync_events_scan") as calls:
            out = receive(label, sizes.ax_scan, sync_method)
        counts[label] = dict(kernels.LAUNCHES)
        got = decoded(out, sizes.frames)
        caps = [(e["unit"], e["nb"], e["replays"]) for e in graphs[0].capture_log]
        receive(f"{label} per chunk", None, sync_method)
        print(f"[13 ax25 graph] ax25_1200_rx_graph sync={sync_method} chunks of "
              f"{sizes.ax_chunk}, scan_chunks={sizes.ax_scan}: "
              f"{len(set(got))}/{sizes.frames} decoded, the per-chunk run's "
              f"list: {got == want}; captured (unit, nb, replays): {caps}; "
              f"launches {json.dumps(counts[label])}; card: {card}")
        if len(set(got)) < sizes.frame_gate or got != want:
            failures.append(f"{label}: {len(set(got))} frames, or not the "
                            "per-chunk run's list")
        if on_card and not caps:
            failures.append(f"{label}: no segment was captured")
        # kernel A on the segment's outputs: bit-equal to the per-chunk card
        # run's, and against the plain versions' at 2e-5 * max|y| a chunk
        mine, theirs = inputs.pop(label), inputs.pop(f"{label} per chunk")
        equal = len(mine) == len(theirs) and all(
            torch.equal(a, b) for a, b in zip(mine, theirs))
        print(f"[13 ax25 graph] {label}: the front-end segment's outputs on its "
              f"{len(mine)} chunks bit-equal to the per-chunk card run's: {equal}")
        if not equal or len(mine) != len(inputs["plain"]):
            failures.append(f"{label}: the segment's outputs differ from the "
                            "per-chunk run's, or their count from the plain run's")
        rel = max((max_err(a, b) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(mine, inputs["plain"])), default=0.0)
        report("13 ax25 graph", f"{label}: kernel A on the front-end segment's "
               f"outputs (3 launches a chunk) vs the plain versions' run, |error| "
               f"/ max|y| of a chunk", rel, 2e-5)
        errs["fir_decimate"] = max(errs["fir_decimate"], max(
            max_err(a, b) for a, b in zip(mine, inputs["plain"])))
        if calls["symbol_sync_events_scan"]:
            errs["symbol_sync_events"] = max(errs["symbol_sync_events"], hold_events_calls(
                "13 ax25 graph", label, calls["symbol_sync_events_scan"]))
        require(label, counts[label], ("fir_decimate", "symbol_sync_events")
                if sync_method == "events" else ("fir_decimate",))
        del calls, graphs, mine, theirs
    del inputs
    end_phase("13 ax25 graph")

    # ---- every capturable block class alone, three batches
    rng = np.random.RandomState(13)
    m = sizes.block_chunk * 13
    for name, make, ins, n_out in capturable_cases(blocks, rng):
        inputs = ins(m)
        want, _ = run_capturable_case(dev, make, inputs, n_out, sizes.block_chunk, None)
        got, g = run_capturable_case(dev, make, inputs, n_out, sizes.block_chunk, 4)
        caps = [(e["nb"], e["replays"]) for e in g.capture_log]
        equal = all(a.shape == b.shape and np.array_equal(a, b)
                    for a, b in zip(got, want))
        print(f"[13 blocks] {name} alone, 13 chunks of {sizes.block_chunk}, "
              f"scan_chunks=4: replays {caps}, every output equal to the "
              f"per-chunk run: {equal}")
        if not equal or (on_card and caps != [(4, 3)]):
            failures.append(f"capturable {name}: {caps}, equal {equal}")
    end_phase("13 blocks")

    # ---- the generators at full width
    def app(name, main_fn, args, needs=()):
        """``main_fn(args + --device)``, its launches counted.  Returns its
        standard output."""
        zero_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
            rc = main_fn(args + ["--device", str(dev)])
        if rc != 0:
            failures.append(f"app {name}: exit code {rc}")
        counts[name] = dict(kernels.LAUNCHES)
        require(name, counts[name], needs)
        return out.getvalue()

    def check(what, ok, line):
        print(f"[13 generators] {what}: {ok}; {line}; card: {card}")
        if not ok:
            failures.append(f"13 generators {what}")

    # tone: 2^24 samples against a float64 sine
    fs_t, f_t, a_t = float(sizes.tone_n), 1_234_567.0, 0.5
    app("tone", tone.main, ["--freq", str(f_t), "--sample_rate", str(fs_t),
                            "--seconds", "1", "--amplitude", str(a_t),
                            "--out", str(d / "tone.c32")])
    y = rawfile.read_samples(str(d / "tone.c32"), "c32")
    t = np.mod(np.arange(1, sizes.tone_n + 1) * (2 * np.pi * f_t / fs_t), 2 * np.pi)
    err = float(np.abs(y - a_t * (np.sin(t) - 1j * np.cos(t))).max()) \
        if len(y) == sizes.tone_n else math.inf
    report("13 generators", f"tone {sizes.tone_n} samples vs a float64 sine",
           err, 1e-6)
    del y, t
    # fm_tx: a 10 s tone as .au -> FM at 240 kHz -> rtl_fm back
    ar, tone_f, tone_a = 48_000, 1000.0, 0.5
    k = np.arange(int(sizes.fm_seconds * ar))
    (d / "tx.au").write_bytes(au.au_encode(
        (tone_a * np.sin(2 * np.pi * tone_f / ar * k)).astype(np.float32), ar))
    app("fm_tx", fm_tx.main, ["-r", str(d / "tx.au"), "--out", str(d / "tx.c32")])
    iq = rawfile.read_samples(str(d / "tx.c32"), "c32")
    app("rtl_fm fm_tx", rtl_fm.main, ["-r", str(d / "tx.c32"), "--sample_rate",
                                      "240k", "--out", str(d / "rx.au")],
        ("fir_decimate",))
    rx = au.au_read(str(d / "rx.au"))[0]
    amps, resid = tone_fit(rx, float(ar), ((tone_f, tone_a),))
    check("fm_tx into rtl_fm: the tone back within 1%",
          len(iq) == len(k) * 5 and abs(amps[0] / tone_a - 1) < 0.01 and resid < 0.01,
          f"{len(iq)} IQ samples, tone {amps[0]:.5f} (sent {tone_a}), residual "
          f"{resid:.5f}")
    del iq, rx
    # spectrum: the main path's capture peaks at the station's bin
    cap = torch.complex(i_main, q_main)
    rawfile.write_samples(str(d / "main.c32"), cap.cpu().numpy())
    text = app("spectrum", spectrum.main, ["-r", str(d / "main.c32"),
                                           "--sample_rate", "1.024m"])
    db = spectrogram(cap, 1024)
    mean = (10 ** (db / 10)).mean(0)
    peak = int(mean.argmax())
    # the station sits at the centre, its deviation 75 kHz either side
    half = int(75_000 / FS_RTL * 1024)
    check("spectrum peaks at the station", abs(peak - 512) <= half and "span:" in text,
          f"{db.shape[0]} frames of 1024, the mean power's peak at bin {peak} "
          f"(the station: 512 +- {half})")
    del cap, db
    # morse_beacon: its envelope is its keying
    app("morse_beacon", morse_beacon.main,
        ["--msg", "CQ CQ DE N0CALL", "--out", str(d / "cw.c32")])
    cw = rawfile.read_samples(str(d / "cw.c32"), "c32")
    key = np.repeat(blocks.morse_encode_bits("CQ CQ DE N0CALL"), int(48_000 * 1.2 / 20))
    check("morse_beacon envelope equals its keying bits",
          len(cw) == len(key) and np.array_equal(np.abs(cw) > 0.5, key == 1),
          f"{len(cw)} samples")
    # pw_tone through run_stream into the file backend
    app("pw_tone", pw_tone.main, ["--freq", "1k", "--seconds", "2", "--volume",
                                  "0.3", "--backend", "file", "--out", str(d / "pw.f32")])
    pw = np.fromfile(d / "pw.f32", "<f4")
    t = np.arange(1, 96_001) * (2 * np.pi * 1000.0 / 48_000.0)
    err = float(np.abs(pw - 0.3 * np.sin(t)).max()) if len(pw) == 96_000 else math.inf
    report("13 generators", "pw_tone --backend file vs a float64 sine", err, 1e-6)
    tmp.cleanup()
    end_phase("13 generators")
    return counts, errs


# ---- phase 14: the recurrences (kernels F and G) and the live feeds

# growing filters whose f32 powers overflow: a pole at 1.001 and one at
# 1 + 1/sqrt(2) (also tests/test_torch_recurrences.py)
IIR_GROWING = {"slow pole": (1.0, 1.001), "fast poles": (1.0, 2.0, -0.5)}
FS_RDS, DS_RDS = 250_000.0, 50_000.0  # rtl_data_stream's default rates
RDS_DEV = 5_000.0       # the station's deviation, Hz
UI_DB_TOL = 0.1         # dB, where the float64 power is within 60 dB of its row's peak


@dataclasses.dataclass(frozen=True)
class LiveSizes:
    """Phase 14's sizes: the defaults on the card; a CPU rehearsal
    (``tests/test_torch_chip_smoke.py``) takes small ones."""

    cma_n: int = 1 << 22        # 4.1 s of the main path's station at 1.024 Msps
    cma_chunk: int = 1 << 18    # CmaEqualizer's run_stream chunk
    window: int = 1 << 14       # outputs held against the plain versions
    cma_f64: int = 1 << 18      # kernel F's windows held against float64
    iir_n: int = 1 << 24        # 5.8 min of 48 kHz audio
    iir_growing: int = 1 << 18  # each stream through a growing filter
    rds_n: int = 1 << 24        # rtl_data_stream's capture: 32 MiB of u8 IQ
    clients: int = 4            # rtl_data_stream --tcp's clients
    feed_c32: int = 1 << 26     # DeviceFeeder's c32 file: 512 MiB
    feed_u8: int = 1 << 26      # and its u8iq file: 128 MiB
    feed_chunk: int = 1 << 20
    ui_fft: int = 2048


def start_app(module: str, args: list, stdin, stdout) -> subprocess.Popen:
    """``python -m module args`` from the repository root, in a process of
    its own, with the given files as its stdin and stdout."""
    return subprocess.Popen([sys.executable, "-m", module, *args], stdin=stdin,
                            stdout=stdout, stderr=subprocess.PIPE,
                            cwd=Path(__file__).resolve().parent)


def iir_sequential(x: torch.Tensor, taps, hist: torch.Tensor) -> torch.Tensor:
    """The IIR recurrence sample after sample in f32 (numpy scalars on the
    host, each operation rounded to f32): taps[0] * x[n], then the terms
    from the oldest output down to taps[2] * y[n - 2], then taps[1] *
    y[n - 1]; what kernel G's first chunk computes.  A CPU tensor out."""
    t = np.asarray(taps, np.float32)
    h = list(hist.cpu().numpy().astype(np.float32))
    ys = np.empty(x.shape[0], np.float32)
    with np.errstate(over="ignore", invalid="ignore"):  # past f32's largest
        for n, v in enumerate(x.cpu().numpy()):
            acc = t[0] * v
            for i in range(len(t) - 1, 1, -1):
                acc = acc + t[i] * h[i - 1]
            y = acc + t[1] * h[0]
            h = [y] + h[:-1]
            ys[n] = y
    return torch.from_numpy(ys)


def iir_growing_streams(n: int):
    """(what, taps, x, history) of the streams on which a growing filter's
    f32 powers overflow, n samples each as CPU tensors: zeros, and a unit
    impulse 2000 samples before the end, through both ``IIR_GROWING``
    filters; an impulse of 1e-30 at sample 0, and a history of 1e-30,
    through the slow pole."""
    out = []
    for name, taps in IIR_GROWING.items():
        hz = torch.zeros(len(taps) - 1)
        late = torch.zeros(n)
        late[n - 2000] = 1.0
        out += [(f"zeros, {name}", taps, torch.zeros(n), hz),
                (f"an impulse 2000 samples before the end, {name}", taps, late, hz)]
    taps = IIR_GROWING["slow pole"]
    tiny = torch.zeros(n)
    tiny[0] = 1e-30
    out += [("an impulse of 1e-30 at sample 0, slow pole", taps, tiny, torch.zeros(1)),
            ("a history of 1e-30, slow pole", taps, torch.zeros(n),
             torch.full((1,), 1e-30))]
    return out


def first_non_finite(y: torch.Tensor) -> int | None:
    bad = torch.nonzero(~torch.isfinite(y))
    return int(bad[0, 0]) if bad.shape[0] else None


def _bits(t: torch.Tensor) -> torch.Tensor:
    return (torch.view_as_real(t) if t.is_complex() else t).cpu()


def live_phase(dev, card: str, sizes: LiveSizes, phase_f64, i_main, q_main):
    """Phase 14 on ``dev``: kernel F (``ops.cma_equalize``, the
    ``CmaEqualizer`` block streamed) on the main path's station at unit
    modulus through a pre-echo channel, held bit-equal to its plain
    version on its first ``sizes.window`` outputs and on a second call over
    the last ``sizes.window`` windows from the first call's taps, the
    streamed and split runs within ``CMA_TOL`` of one call, and the one
    call within ``CMA_TOL`` of ``cma_sequential`` in float64 over
    ``sizes.window`` windows and in f32 over ``sizes.cma_f64``; kernel G (``ops.iir_filter`` at orders 2
    and 8) on noise, held bit-equal to its plain version over the whole
    stream and, on its first chunk, to the sequential form
    (``iir_sequential``); ``rtl_data_stream`` (``downsample_u8`` with kernel A
    held on its calls, the plain versions' bytes within one LSB, the app's
    stdin/stdout protocol in a process of its own, ``sizes.clients`` TCP
    clients); ``DeviceFeeder`` on a c32 and a u8iq file; ``ui_server``'s
    ``SpectrumFeed`` and ``UiServer`` on the main capture.  Returns the
    launch counts of each path and the largest |error| of each kernel held
    here."""
    import asyncio
    import io
    import tempfile

    from rustradio_tpu_torch import blocks, ops, runtime
    from rustradio_tpu_torch.apps import rtl_data_stream as rds
    from rustradio_tpu_torch.graph import Graph
    from rustradio_tpu_torch.io import data_stream, rawfile
    from rustradio_tpu_torch.io import websocket as ws
    from rustradio_tpu_torch.ops import kernels
    from rustradio_tpu_torch.ui import SpectrumFeed, UiServer

    counts = {}
    errs = {"cma": 0.0, "iir": 0.0, "fir_decimate": 0.0}
    tmp = tempfile.TemporaryDirectory()
    d = Path(tmp.name)
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    win = sizes.window

    def same(ph, what, got, want) -> None:
        ok = got.shape == want.shape and torch.equal(_bits(got), _bits(want))
        print(f"[{ph}] {what}: bit-equal {ok}")
        if not ok:
            failures.append(f"{ph} {what}")

    def check(ph, what, ok, line):
        print(f"[{ph}] {what}: {ok}; {line}; card: {card}")
        if not ok:
            failures.append(f"{ph} {what}")

    # ---- rtl_data_stream: an FM station at 250 kHz as rtl-sdr u8 IQ
    n = sizes.rds_n
    t = torch.arange(n, dtype=torch.float64, device=dev)
    audio = (0.6 * torch.sin(2 * math.pi * 1000.0 / FS_RDS * t)
             + 0.3 * torch.sin(2 * math.pi * 3100.0 / FS_RDS * t + 0.5))
    ph = torch.cumsum(audio, 0) * (2 * math.pi * RDS_DEV / FS_RDS)
    noise = torch.randn((2, n), generator=gen, device=dev, dtype=torch.float64)
    iq = torch.complex(0.45 * torch.cos(ph) + 0.02 * noise[0],
                       0.45 * torch.sin(ph) + 0.02 * noise[1]).to(torch.complex64)
    raw = rawfile.rtlsdr_encode(iq)
    del t, audio, ph, noise, iq
    raw.cpu().numpy().tofile(d / "rds.u8")
    ctl = data_stream.encode_version() + data_stream.encode_request_data(
        "rtl-sdr", 0xFFFFFFFF)
    (d / "ctl.bin").write_bytes(ctl)
    # the app itself, from its command line, in a process of its own
    with open(d / "ctl.bin", "rb") as fin, open(d / "out.bin", "wb") as fout:
        app = start_app("rustradio_tpu_torch.apps.rtl_data_stream",
                        ["-r", str(d / "rds.u8"), "--device", str(dev)], fin, fout)
    zero_counts()
    with capturing("fir_decimate") as calls:
        payload = rds.downsample_u8(raw, FS_RDS, DS_RDS)
    sync()
    counts["rtl_data_stream"] = dict(kernels.LAUNCHES)
    require("rtl_data_stream", counts["rtl_data_stream"], ("fir_decimate",))
    errs["fir_decimate"] = hold_fir_calls(
        "14 rtl_data_stream", "downsample_u8", calls["fir_decimate"])
    with plain_versions():
        plain = rds.downsample_u8(raw, FS_RDS, DS_RDS)
    a = np.frombuffer(payload, np.uint8).astype(np.int16)
    b = np.frombuffer(plain, np.uint8).astype(np.int16)
    lsb = int(np.abs(a - b).max()) if a.shape == b.shape else 256
    report("14 rtl_data_stream", f"downsample_u8 of {n} samples vs the plain "
           f"versions' run, largest byte difference (LSB; {int((a != b).sum())} "
           f"of {len(a)} bytes differ)", lsb, 1)
    out = io.BytesIO()
    rds.serve_stdio(payload, io.BytesIO(ctl), out)
    events = data_stream.BytesReader().feed(out.getvalue())
    check("14 rtl_data_stream", "serve_stdio's Data packets carry the payload",
          b"".join(e[2] for e in events if e[0] == "data") == payload,
          f"{len(events)} packets")

    async def tcp_clients():
        srv = data_stream.DataStreamServer(rds.payload_reader(payload, False),
                                           "rtl-sdr", 16_384)
        _, port = await srv.serve()

        async def client():
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            r, w = data_stream.AsyncReader(reader), data_stream.AsyncWriter(writer)
            await w.write_version()
            await r.read_version()
            await w.write_request_data("rtl-sdr", len(payload))
            buf = bytearray()
            while len(buf) < len(payload):
                pkt = await asyncio.wait_for(r.read_packet(), timeout=30)
                if pkt is None:
                    break
                buf += pkt[2]
            writer.close()
            return bytes(buf)

        got = await asyncio.gather(*[client() for _ in range(sizes.clients)])
        await srv.close()
        return got

    got = asyncio.run(asyncio.wait_for(tcp_clients(), timeout=300))
    check("14 rtl_data_stream", f"--tcp: {sizes.clients} concurrent clients on "
          "loopback each receive the whole payload",
          all(g == payload for g in got), f"{[len(g) for g in got]} bytes")
    end_phase("14 rtl_data_stream")

    # ---- kernel F: the CMA equalizer on the station at unit modulus
    n = sizes.cma_n
    x = cma_channel(phase_f64, n, gen)
    zero_counts()
    y, taps_end = ops.cma_equalize(x, CMA_TAPS, 1.0, CMA_MU)
    g = Graph()
    sink = g.add(blocks.VectorSink(), g.add(blocks.CmaEqualizer(CMA_TAPS, 1.0, CMA_MU),
                                            g.add(blocks.VectorSource(x))))
    g.run_stream(chunk_size=sizes.cma_chunk, device=dev)
    counts["cma"] = dict(kernels.LAUNCHES)
    require("cma_equalize and CmaEqualizer", counts["cma"], ("cma",))

    def near(what, got, want, of="y"):
        err = (float((got.to(want.device) - want).abs().max() / want.abs().max())
               if got.shape == want.shape else math.inf)
        report("14 cma", f"{what}, |error| / max|{of}|", err, CMA_TOL)

    # blocks of windows count from each call's start, so calls cut
    # elsewhere than at a block round in another order
    streamed = torch.from_numpy(np.asarray(sink.block.data(), np.complex64))
    near(f"CmaEqualizer streamed in chunks of {sizes.cma_chunk} vs one "
         f"cma_equalize call ({n - CMA_TAPS + 1} outputs)", streamed, y)
    if streamed.shape == y.shape:
        # how the seams' gap grows with the stream: one seam a chunk
        gaps = [(k, float((streamed[:k] - y[:k].cpu()).abs().max()
                          / y[:k].abs().max()))
                for k in sorted({min(sizes.cma_chunk << 2 * i, y.shape[0])
                                 for i in range(3)})]
        print("[14 cma] streamed vs one call, |error| / max|y| over the first "
              + ", ".join(f"{k} windows {g:.3e}" for k, g in gaps))
    # f32 itself drifts from float64 along CMA's free phase: the one call
    # is held to float64 over the held window, and over sizes.cma_f64
    # windows to the sequential f32 recurrence, both errors against
    # float64 printed
    k64 = min(sizes.cma_f64, y.shape[0])
    xh = x[: k64 + CMA_TAPS - 1].cpu().numpy()
    y64 = cma_sequential(xh, CMA_TAPS, 1.0, CMA_MU)
    y32 = cma_sequential(xh, CMA_TAPS, 1.0, CMA_MU, np.complex64)
    yh = y[:k64].cpu().numpy()

    def rel(a, b, k):
        return float(np.abs(a[:k] - b[:k]).max() / np.abs(b[:k]).max())

    kw = min(win, k64)
    report("14 cma", f"one call's first {kw} outputs vs the float64 model, "
           "|error| / max|y|", rel(yh, y64, kw), CMA_TOL)
    report("14 cma", f"one call's first {k64} outputs vs the sequential f32 "
           "recurrence, |error| / max|y|", rel(yh, y32, k64), CMA_TOL)
    print(f"[14 cma] against the float64 model over the first {k64} windows, "
          f"|error| / max|y|: the one call {rel(yh, y64, k64):.3e}, the "
          f"sequential f32 recurrence {rel(y32, y64, k64):.3e}")
    del streamed, xh, y64, y32, yh
    quarter = y.shape[0] // 4

    def dispersion(v):
        return float(((v.abs() ** 2 - 1) ** 2).mean())

    dy, dx = dispersion(y[-quarter:]), dispersion(x[-quarter:])
    check("14 cma", "modulus dispersion of the last quarter at most half the "
          "input's", dy <= 0.5 * dx,
          f"mean((|y|^2-1)^2) {dy:.3e}, input's {dx:.3e}, final |taps| "
          f"{np.round(taps_end.abs().cpu().numpy(), 3).tolist()}")
    cut = y.shape[0] - win
    y1, t1 = ops.cma_equalize(x[: cut + CMA_TAPS - 1], CMA_TAPS, 1.0, CMA_MU)
    y2, t2 = ops.cma_equalize(x[cut:], CMA_TAPS, 1.0, CMA_MU, taps=t1)
    near(f"two calls split at the last {win} windows, the taps carried, vs one "
         "call", torch.cat([y1, y2]), y)
    near("the split's final taps vs one call's", t2, taps_end, "taps")
    t0 = torch.zeros(CMA_TAPS, dtype=torch.complex64)
    t0[0] = 1.0
    py, _ = kernels.cma_scan_plain(x[: win + CMA_TAPS - 1].cpu(), t0, 1.0, CMA_MU)
    same("14 cma", f"kernel F vs plain, the first {win} outputs", y[:win], py)
    py, pt = kernels.cma_scan_plain(x[cut:].cpu(), t1.cpu(), 1.0, CMA_MU)
    same("14 cma", f"kernel F vs plain, the split's second call ({win} "
         "windows from the first call's taps)", y2, py)
    same("14 cma", "kernel F vs plain, the final taps", t2, pt)
    end_phase("14 cma")

    # ---- kernel G: the IIR filter on noise
    n = sizes.iir_n
    xi = torch.randn(n, generator=gen, device=dev)
    zero_counts()
    outs = {}
    for name, taps in IIR_TAPS.items():
        outs[name] = ops.iir_filter(xi, taps)
    counts["iir"] = dict(kernels.LAUNCHES)
    require("iir_filter", counts["iir"], ("iir",))
    head = min(n, kernels.IIR_CHUNK)
    for name, taps in IIR_TAPS.items():
        yi, order = outs[name], len(taps) - 1
        hz = torch.zeros(order, device=dev)
        plain = kernels.iir_scan_plain(xi, taps, hz)  # torch ops on dev
        same("14 iir", f"{name}: kernel G vs plain over the whole stream "
             f"({n} samples)", yi, plain)
        errs["iir"] = max(errs["iir"], max_err(yi, plain))
        del plain
        same("14 iir", f"{name}: kernel G's first {head} samples (its first "
             "chunk) vs the sequential form", yi[:head],
             iir_sequential(xi[:head].cpu(), taps, torch.zeros(order)))
        y64 = iir_f64(xi, taps)
        report("14 iir", f"{name}: {n} samples vs the float64 model, "
               "|error| / max|y|",
               float((yi.double() - y64).abs().max() / y64.abs().max()), IIR_TOL)
        del y64
    del outs
    # growing filters, whose f32 powers overflow: the kernel bit-equal to
    # its plain version (NaN where it is NaN), both finite wherever the
    # sequential f32 recurrence is, to within 4 samples of its first
    # non-finite output
    for what, taps, xs, hs in iir_growing_streams(sizes.iir_growing):
        yk = ops.iir_filter(xs.to(dev), taps, hs.to(dev))
        yp = kernels.iir_scan_plain(xs.to(dev), taps, hs.to(dev))
        nk, np_ = yk.isnan(), yp.isnan()
        ok = (yk.shape == yp.shape and torch.equal(nk, np_)
              and torch.equal(yk[~nk].cpu(), yp[~np_].cpu()))
        seq = first_non_finite(iir_sequential(xs, taps, hs))
        ends = [first_non_finite(v) for v in (yk, yp)]
        finite = all((e is None) == (seq is None)
                     and (seq is None or abs(e - seq) <= 4) for e in ends)
        print(f"[14 iir] {what}: kernel G vs plain over {sizes.iir_growing} "
              f"samples, bit-equal {ok} (NaN where NaN); first non-finite "
              f"output: kernel {ends[0]}, plain {ends[1]}, sequential f32 {seq}; "
              f"last output {float(yk[-1])!r}")
        if not ok:
            failures.append(f"14 iir {what}: kernel G vs plain")
        if not finite:
            failures.append(f"14 iir {what}: non-finite where the sequential "
                            "form is finite")
    end_phase("14 iir")

    # the app's process: its stdout's Data packets are the payload
    try:
        _, err = app.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        app.kill()
        _, err = app.communicate()
    events = data_stream.BytesReader().feed((d / "out.bin").read_bytes())
    check("14 rtl_data_stream", "the app's stdin/stdout protocol: the bytes "
          "served equal downsample_u8's",
          app.returncode == 0 and events[:1] == [("version", 0)]
          and b"".join(e[2] for e in events if e[0] == "data") == payload,
          f"exit code {app.returncode}, {len(events)} packets"
          + (f"; stderr: {err.decode()[-500:]}" if app.returncode else ""))
    end_phase("14 rtl_data_stream app")

    del x, y, y1, y2, xi

    # ---- DeviceFeeder: a c32 and a u8iq file to the card
    c32 = torch.complex(torch.randn(sizes.feed_c32, generator=gen, device=dev),
                        torch.randn(sizes.feed_c32, generator=gen, device=dev))
    c32.cpu().numpy().tofile(d / "feed.c32")
    del c32
    torch.randint(0, 256, (2 * sizes.feed_u8,), generator=gen, device=dev,
                  dtype=torch.uint8).cpu().numpy().tofile(d / "feed.u8")
    for fmt, fname in (("c32", "feed.c32"), ("u8iq", "feed.u8")):
        path = d / fname
        nbytes = path.stat().st_size
        with runtime.DeviceFeeder(str(path), fmt, sizes.feed_chunk, device=dev) as feed:
            chunks = list(feed)
        raw_np = np.fromfile(path, np.uint8)
        if fmt == "c32":
            v = raw_np.view(np.complex64)
            want = (v.real.copy(), v.imag.copy())
        else:
            f = raw_np.astype(np.float32) - np.float32(127.0)
            want = (f[0::2] * np.float32(0.008), f[1::2] * np.float32(0.008))
        del raw_np
        ok = all(c[0].shape[0] == sizes.feed_chunk for c in chunks)
        for k in (0, 1):
            ok = ok and torch.equal(torch.cat([c[k] for c in chunks]),
                                    torch.from_numpy(want[k]).to(dev))
        check("14 feeder", f"DeviceFeeder {fmt}: every chunk kept equals "
              "np.fromfile's planes after the last copy", ok,
              f"{len(chunks)} chunks of {sizes.feed_chunk} samples, "
              f"{nbytes / 2**20:.0f} MiB")
        del chunks, want
    end_phase("14 feeder")

    # ---- ui_server: SpectrumFeed and UiServer on the main capture
    cap = torch.complex(i_main, q_main)
    fft = sizes.ui_fft
    chunk = max(int(FS_RTL / 4), fft)  # ui_server's chunk
    parts = [cap[k : k + chunk] for k in range(0, cap.shape[0], chunk)]
    feed = SpectrumFeed(iter(parts), FS_RTL, fft_size=fft, realtime=False,
                        device=dev, history=4096)
    srv = UiServer(feed).start()
    feed.join(timeout=600)
    try:
        start, nxt, rows = feed.frames_since(0, limit=1 << 20)
        hop = max(int(FS_RTL / feed.fps), fft)
        win64 = np.hanning(fft)
        want = []
        for part in parts:
            v = part.cpu().numpy().astype(np.complex128)
            nf = max((len(v) - fft) // hop + 1, 0)
            for k in range(nf):
                spec = np.fft.fftshift(np.fft.fft(v[k * hop : k * hop + fft] * win64))
                want.append(10 * np.log10(np.abs(spec) ** 2 + 1e-20))
        got, want = np.asarray(rows), np.asarray(want)
        ok = feed.done and feed.error is None and got.shape == want.shape
        err = math.inf
        if ok:
            near = want >= want.max(axis=1, keepdims=True) - 60.0
            err = float(np.abs(got - want)[near].max())
        report("14 ui", f"SpectrumFeed {len(rows)} rows of {fft} vs a float64 numpy "
               "spectrogram, |dB error| where within 60 dB of the row's peak",
               err, UI_DB_TOL)
        peak = int((10 ** (want / 10)).mean(0).argmax()) if ok else -1
        half = int(75_000 / FS_RTL * fft)
        check("14 ui", "the mean power peaks at the station",
              abs(peak - fft // 2) <= half,
              f"bin {peak} (the station: {fft // 2} +- {half}); {len(rows)} rows")
        with urllib.request.urlopen(srv.address + "/api/frames?since=0",
                                    timeout=30) as r:
            body = json.loads(r.read())
        host, port = srv.httpd.server_address[:2]

        async def ws_rows():
            reader, writer = await asyncio.open_connection(host, port)
            await ws.client_handshake(reader, writer, f"{host}:{port}", "/ws?since=0")
            got = []
            while not got:
                op, data = await asyncio.wait_for(ws.read_frame(reader), timeout=30)
                if op == ws.OP_BINARY:
                    got = json.loads(data.decode()).get("rows", [])
            writer.close()
            return got

        pushed = asyncio.run(asyncio.wait_for(ws_rows(), timeout=60))
        check("14 ui", "one HTTP fetch and one websocket fetch of rows",
              len(body["rows"]) > 0 and len(pushed) > 0
              and len(bytes.fromhex(body["rows"][0])) == fft
              and pushed[0] == body["rows"][0],
              f"{len(body['rows'])} rows over HTTP, {len(pushed)} over the websocket")
    finally:
        srv.stop()
    tmp.cleanup()
    end_phase("14 ui")
    return counts, errs


# ---- phase 15: the multi-device layer, one shot

MESH_SHARDS = 4           # shards of the mesh, all on the one card
MESH_CHANNELS = 256       # the channelizer bank of the dry run


@dataclasses.dataclass(frozen=True)
class MeshSizes:
    """Phase 15's sizes: the defaults on the card; a CPU rehearsal
    (``tests/test_torch_chip_smoke.py``) takes small ones.  The FM ops run
    on the whole main capture given, the AX.25 front-end on the whole
    corpus given."""

    shards: int = MESH_SHARDS
    bank_ch: int = BANK_CH            # the decode bank: 4 shards of 16 channels
    bank_n: int = BANK_N
    bank_events: int = BANK_EVENTS
    channels: int = MESH_CHANNELS
    chan_n: int = 1 << 22             # the channelizer's input samples
    frames: int = N_FRAMES            # corpus frames of the audio given
    frame_gate: int = FRAME_GATE


def mesh_phase(dev, card: str, sizes: MeshSizes, i_main, q_main, audio, want):
    """Phase 15: the multi-device layer's one-shot half on a mesh of
    ``sizes.shards`` shards, all on ``dev`` (the one card): the sharded FM
    chain, ``sharded_fir_filter`` and ``sharded_fft_filter`` at 49 taps /
    deci 4 and ``sharded_quadrature_demod`` on the main capture, each held
    against its offline op; the channel-sharded clock recovery (kernels E
    and D) on the decode bank, bit-equal to the unsharded call; the
    channel-sharded channelizer bank against ``channelizer_fm_bank``; the
    AX.25 front-end sharded over the corpus ``audio`` and the native tail,
    its list ``want`` (the offline receiver's); and
    ``tools.dryrun.dryrun_multichip``.  Each sharded call is counted apart
    (the kernels launched once a shard).  Returns the launch counts of each
    path and the largest |error| of each kernel held here."""
    from rustradio_tpu_torch import ops, parallel, taps as tapgen
    from rustradio_tpu_torch.models.ax25 import bell202_demod
    from rustradio_tpu_torch.models.multichannel import recover_symbols_batch
    from rustradio_tpu_torch.ops import kernels
    from rustradio_tpu_torch.tools.dryrun import dryrun_multichip

    on_card = dev.type == "cuda"
    mdev = torch.device("cuda", 0) if on_card else dev
    n_sh = sizes.shards
    mesh = parallel.make_mesh(n_sh, device=mdev)
    cmesh = parallel.make_mesh(n_sh, axis="chan", device=mdev)
    counts, errs = {}, {}

    def counted(name, fn, needs):
        """``fn()`` with the counts set to 0 just before and read just
        after; on the card each kernel of ``needs`` launched exactly its
        count (once a shard)."""
        zero_counts()
        out = fn()
        sync()
        counts[name] = dict(kernels.LAUNCHES)
        for k, times_n in needs.items():
            if on_card and counts[name][k] != times_n:
                failures.append(f"{name}: kernel {k} launched {counts[name][k]} "
                                f"times, not {times_n}")
        print(f"[15 mesh] {name}: launches {json.dumps(counts[name])}; card: {card}")
        return out

    iq = torch.complex(i_main, q_main)
    n = iq.shape[0]
    lp = tapgen.low_pass_complex(FS_RTL, 100_000.0, 50_000.0, "hamming")
    if len(lp) != 49:
        raise SystemExit(f"chip_smoke: the FM taps are {len(lp)}, not 49")
    what = f"{n_sh} shards, 2^{n.bit_length() - 1} samples"

    # the FM chain: FirFilter(49, deci 4) -> QuadratureDemod, kernel A once
    # a shard; the offline chain over its own length.  Bit-equal where
    # kernel A's sum for an output does not depend on where its tile
    # starts; else within kernel A's 2e-5 * max|y| on each filtered sample
    # of a pair, through the exact discriminator (2 * 2e-5 * max|y|/min|y|)
    y = counted("sharded_fm_demod", lambda: parallel.sharded_fm_demod(
        iq, lp, mesh, deci=DECI), {"fir_decimate": n_sh})
    y2 = counted("sharded_fm_demod again", lambda: parallel.sharded_fm_demod(
        iq, lp, mesh, deci=DECI), {"fir_decimate": n_sh})
    filt = ops.fir_filter(iq, lp, DECI)
    want_fm = ops.quadrature_demod(filt, 1.0)
    m = min(y.shape[0], want_fm.shape[0])
    if m < want_fm.shape[0] - 1 or not torch.equal(y, y2):
        failures.append("sharded_fm_demod: short of the offline chain, or two "
                        "calls differ")
    unequal = int((y[:m] != want_fm[:m]).sum())
    report(
        "15 mesh", f"sharded_fm_demod {what}, 49 taps deci 4: {m} outputs vs the "
        f"offline chain ({unequal} not bit-equal)", wrapped_err(y[:m], want_fm[:m], 1.0),
        2 * 2e-5 * envelope_ratio(filt, 0))
    del y2
    # kernel A on the sharded chain's own calls (each shard's window and its
    # halo) against its plain version
    with capturing("fir_decimate") as calls:
        parallel.sharded_fm_demod(iq, lp, mesh, deci=DECI)
    errs["fir_decimate"] = hold_fir_calls("15 mesh", f"sharded_fm_demod {what}",
                                          calls["fir_decimate"])
    del calls

    # the FIR alone (full convolution) and the overlap-save FFT filter
    got = counted("sharded_fir_filter", lambda: parallel.sharded_fir_filter(
        iq, lp, mesh, deci=DECI), {"fir_decimate": n_sh})
    want_f = ops.fir_filter_full(iq, lp, DECI)
    unequal = int((got != want_f).sum()) if got.shape == want_f.shape else -1
    report("15 mesh", f"sharded_fir_filter {what}, 49 taps deci 4 vs "
           f"fir_filter_full ({unequal} not bit-equal)", max_err(
               torch.view_as_real(got), torch.view_as_real(want_f)),
           2e-5 * float(want_f.abs().max()))
    got = counted("sharded_fft_filter", lambda: parallel.sharded_fft_filter(
        iq, lp, mesh), {})
    want_f = ops.fft_filter(iq, lp)
    # other FFT frames than the offline op's: f32 FFT rounding of each
    report("15 mesh", f"sharded_fft_filter {what}, 49 taps vs fft_filter",
           max_err(torch.view_as_real(got), torch.view_as_real(want_f)),
           1e-5 * float(want_f.abs().max()))
    del got, want_f

    # the discriminator alone: a right halo of one sample; the last global
    # output is 0
    got = counted("sharded_quadrature_demod",
                  lambda: parallel.sharded_quadrature_demod(iq, GAIN_C, mesh), {})
    want_q = ops.quadrature_demod(iq, GAIN_C)
    unequal = int((got[:-1] != want_q).sum())
    report("15 mesh", f"sharded_quadrature_demod {what} vs quadrature_demod "
           f"({unequal} not bit-equal; the last output {float(got[-1])})",
           wrapped_err(got[:-1], want_q, GAIN_C), 1e-6 * GAIN_C)
    if float(got[-1]) != 0.0:
        failures.append("sharded_quadrature_demod: the last output is not 0")
    del got, want_q
    end_phase("15 mesh fm")

    # the clock recovery with the channel axis sharded: bit-equal to the
    # unsharded call, kernel E (scan) and kernel D (events) once a shard
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    bank = decode_bank(dev, gen, sizes.bank_ch, sizes.bank_n)
    for method, kernel in (("scan", "symbol_sync_scan"),
                           ("events", "symbol_sync_events")):
        kw = dict(method=method, max_events=sizes.bank_events, return_valid=True)
        name = f"sharded_symbol_sync_bank {method}"
        got = counted(name, lambda: parallel.sharded_symbol_sync_bank(
            bank, BANK_SPS, cmesh, **kw), {kernel: n_sh})
        one = recover_symbols_batch(bank, BANK_SPS, **kw)
        err = max(max_err(a.float(), b.float()) for a, b in zip(got, one))
        report("15 bank", f"{name}: {sizes.bank_ch} x {sizes.bank_n} over {n_sh} "
               f"shards of {sizes.bank_ch // n_sh} channels vs the unsharded call "
               f"(values, mask, clocks, valid; {int(got[3].sum())} valid)", err, 0.0)
    # kernels E and D on the shards' own calls against their plain versions
    with capturing("symbol_sync_scan", "symbol_sync_events_scan") as calls:
        for method in ("scan", "events"):
            parallel.sharded_symbol_sync_bank(bank, BANK_SPS, cmesh, method=method,
                                              max_events=sizes.bank_events)
    errs["symbol_sync_scan"] = hold_scan_calls(
        "15 bank", "sharded_symbol_sync_bank scan", calls["symbol_sync_scan"],
        window=1 << 12)
    errs["symbol_sync_events"] = hold_events_calls(
        "15 bank", "sharded_symbol_sync_bank events", calls["symbol_sync_events_scan"])
    del bank, got, one, calls

    # the channelizer bank with the channel axis sharded
    ctaps = parallel.channelizer_taps(sizes.channels)
    xw = iq[: sizes.chan_n]
    got = counted("sharded_channelizer_fm", lambda: parallel.sharded_channelizer_fm(
        xw, ctaps, sizes.channels, cmesh), {})
    want_c = parallel.channelizer_fm_bank(xw, ctaps, sizes.channels)
    report("15 bank", f"sharded_channelizer_fm {sizes.channels} channels of "
           f"{sizes.chan_n} samples over {n_sh} shards vs channelizer_fm_bank "
           f"({int((got != want_c).sum()) if got.shape == want_c.shape else -1} "
           "not bit-equal)", max_err(got, want_c), 1e-5)
    del got, want_c
    end_phase("15 bank")

    # the AX.25 front-end sharded over the corpus (padded with zeros to the
    # mesh's multiple), then the native tail: the offline receiver's list
    n_a = audio.shape[0]
    pad = (-n_a) % n_sh
    audio_p = torch.cat([audio, audio.new_zeros(pad)])
    nrz = counted("sharded_bell202_demod", lambda: parallel.sharded_bell202_demod(
        audio_p, FS_AUDIO, mesh), {"fir_decimate": 3 * n_sh})[: n_a - 1]
    off = bell202_demod(audio, FS_AUDIO)
    near = int(((nrz - off).abs() > 1e-3).sum())
    syms = ops.recover_symbols(nrz, FS_AUDIO / 1200.0, 0.5, (1 / 6,) * 6)
    bits = ops.nrzi_decode(ops.binary_slicer(torch.from_numpy(syms)))
    pkts, _ = ops.hdlc_deframe(bits, 10, 1500)
    got_l = decoded([bytes(np.asarray(d)) for d, _ in pkts], sizes.frames)
    print(f"[15 ax25] sharded_bell202_demod on the corpus ({n_a} samples, padded "
          f"by {pad}) over {n_sh} shards, then the native tail: "
          f"{len(set(got_l))}/{sizes.frames} decoded, the offline receiver's list: "
          f"{got_l == want}; NRZ samples more than 1e-3 from the offline "
          f"front-end's: {near} of {nrz.shape[0]} (the exact discriminator turns "
          f"a last-ulp FIR difference at a near-zero analytic sample into "
          f"another angle); card: {card}")
    if len(set(got_l)) < sizes.frame_gate or got_l != want:
        failures.append(f"sharded_bell202_demod: {len(set(got_l))} frames, or not "
                        "the offline receiver's list")
    end_phase("15 ax25")

    res = dryrun_multichip(sizes.shards, device=mdev)
    if not res.get("ok"):
        failures.append(f"dryrun_multichip: {res}")
    end_phase("15 dryrun")
    return counts, errs


# ---- phase 16: the multi-device layer, streamed


@dataclasses.dataclass(frozen=True)
class MeshStreamSizes:
    """Phase 16's sizes: the defaults on the card; a CPU rehearsal
    (``tests/test_torch_chip_smoke.py``) takes small ones.  The corpus
    runs on the whole audio given."""

    shards: int = MESH_SHARDS
    chunk: int = 1 << 18              # the corpus stream: 55 chunks, the last ragged
    scan: int = 16
    resume_after: int = RESUME_AFTER  # chunks before the checkpointed pause
    frames: int = N_FRAMES
    frame_gate: int = FRAME_GATE
    fm_chunk: int = 1 << 20           # phase 13's FM stream on the mesh
    fm_chunks: int = 64
    fm_scan: int = 64


def graph_of(fn):
    """(``fn()``, the Graph whose ``run_stream`` or ``run`` it called last):
    the graph a model function builds inside, for its ``demotions``."""
    from rustradio_tpu_torch.graph import Graph

    seen = []

    def spy(real):
        def method(g, *a, **k):
            seen.append(g)
            return real(g, *a, **k)
        return method

    with mock.patch.object(Graph, "run_stream", spy(Graph.run_stream)), \
         mock.patch.object(Graph, "run", spy(Graph.run)):
        out = fn()
    return out, seen[-1]


def mesh_stream_phase(dev, card: str, sizes: MeshStreamSizes, audio):
    """Phase 16: the multi-device layer's streaming half on a mesh of
    ``sizes.shards`` shards, all on ``dev`` (the one card).

    The AX.25 corpus ``audio`` through ``ax25_1200_rx_graph(mesh=,
    chunk_size=)`` with both syncs, per chunk and with ``scan_chunks``,
    and paused at a checkpoint and resumed: each >= the gate and the
    unsharded graph's list, the front-end's ragged last chunk demoted once
    and no other, kernel A 3 launches a shard a chunk (the demoted chunk
    3), kernels A and D held against their plain versions on the events
    run's own calls.  Phase 13's FM chain (FIR 49 taps deci 4 ->
    QuadratureDemod -> gain) streamed on the mesh per chunk and batched:
    bit-equal to ``shard_chain`` of the same blocks over the whole stream
    on the card (kernel A's sum for an output does not depend on where its
    call starts; the discriminator is exact), the batched run bit-equal to
    the per-chunk one, within kernel B's budget of the unsharded stream
    (which lowers the pair to kernel B), never demoted.  Returns the launch
    counts of each path and the largest |error| of each kernel held here."""
    import tempfile

    from rustradio_tpu_torch import blocks, ops, parallel
    from rustradio_tpu_torch.graph import Graph
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.ops import kernels
    from rustradio_tpu_torch.parallel.graph_mesh import chain_segment, shard_chain

    on_card = dev.type == "cuda"
    mdev = torch.device("cuda", 0) if on_card else dev
    n_sh = sizes.shards
    mesh = parallel.make_mesh(n_sh, device=mdev)
    counts = {}
    audio = torch.as_tensor(audio).to(mdev)
    n_a = audio.shape[0]
    chunks = -(-n_a // sizes.chunk)
    front_nodes = ax25_receiver(audio, "native", 6)[0].nodes[1:6]
    front = chain_segment([nd.block for nd in front_nodes], mesh)  # its plan
    front_name = Graph._unit_name(front_nodes)
    last = n_a - (chunks - 1) * sizes.chunk
    want_dem = ([chunks - 1] if last % (n_sh * front.div) or last < front.min_chunk
                else [])
    # kernel A a run: the 3 FIR stages once a shard a sharded chunk, once a
    # demoted chunk
    want_a = 3 * n_sh * (chunks - len(want_dem)) + 3 * len(want_dem)

    def check_run(label, got, want, demotions):
        """The list, the front-end's demotions (``want_dem``) and the other
        mesh segment's (BinarySlicer + NrziDecode, fed the symbols: a chunk
        of no fixed length, so it demotes at the stream's first chunk, as
        in the JAX package), and kernel A's launches."""
        c = counts[label]
        fronts = [d["chunk"] for d in demotions if d["segment"] == front_name]
        others = [(d["segment"], d["chunk"]) for d in demotions
                  if d["segment"] != front_name]
        ok = (len(set(got)) >= sizes.frame_gate and got == want
              and fronts == want_dem and all(k == 0 for _, k in others))
        print(f"[16 mesh ax25] {label}: {len(set(got))}/{sizes.frames} decoded, "
              f"the unsharded graph's list: {got == want}; the front-end demoted "
              f"at chunks {fronts} (want {want_dem}), the other segments at "
              f"{others}; launches {json.dumps(c)}; card: {card}")
        if not ok:
            failures.append(f"{label}: {len(set(got))} frames, not the unsharded "
                            f"list, or demotions {fronts} {others}")
        if on_card and c["fir_decimate"] != want_a:
            failures.append(f"{label}: kernel A launched {c['fir_decimate']} "
                            f"times, not {want_a}")

    for method in ("native", "events"):
        needs = ("fir_decimate", "symbol_sync_events") if method == "events" else (
            "fir_decimate",)
        want = decoded(ax25.ax25_1200_rx_graph(
            audio, FS_AUDIO, chunk_size=sizes.chunk, sync=method), sizes.frames)
        for scan in (None, sizes.scan):
            label = f"ax25_1200_rx_graph mesh sync={method} scan_chunks={scan}"
            zero_counts()
            (got, g) = graph_of(lambda: decoded(ax25.ax25_1200_rx_graph(
                audio, FS_AUDIO, mesh, chunk_size=sizes.chunk, sync=method,
                scan_chunks=scan), sizes.frames))
            counts[label] = dict(kernels.LAUNCHES)
            check_run(label, got, want, g.demotions)
            require(label, counts[label], needs)
        if method == "events":
            want_events = want

    # 20 + 35 chunks around a checkpoint of the mesh run
    with tempfile.TemporaryDirectory() as ck_dir:
        ck = str(Path(ck_dir) / "mesh.pkl")
        zero_counts()
        g1, first = ax25_receiver(audio, "events")
        g1.run_stream(chunk_size=sizes.chunk, max_chunks=sizes.resume_after,
                      checkpoint_path=ck, checkpoint_every=sizes.resume_after,
                      device=mdev, mesh=mesh)
        g2, rest = ax25_receiver(audio, "events")
        g2.run_stream(chunk_size=sizes.chunk, resume_from=ck, device=mdev, mesh=mesh)
        counts["mesh resumed"] = dict(kernels.LAUNCHES)
    got = decoded([bytes(np.asarray(p.data)) for p in first.pdus()]
                  + [bytes(np.asarray(p.data)) for p in rest.pdus()], sizes.frames)
    label = (f"events on the mesh, {sizes.resume_after} chunks, a checkpoint, "
             "then the rest")
    counts[label] = counts.pop("mesh resumed")
    # the demotions of both calls, counted in chunks of the stream
    check_run(label, got, want_events, g1.demotions + [
        dict(d, chunk=d["chunk"] + sizes.resume_after) for d in g2.demotions])
    require(label, counts[label], ("fir_decimate", "symbol_sync_events"))

    # kernels A and D on the events run's own calls
    with capturing("fir_decimate", "symbol_sync_events_scan") as calls:
        out = ax25.ax25_1200_rx_graph(audio, FS_AUDIO, mesh, chunk_size=sizes.chunk,
                                      sync="events")
    if decoded(out, sizes.frames) != want_events:
        failures.append("mesh ax25: the captured run differs")
    what = f"ax25_1200_rx_graph events on {n_sh} shards, chunks of {sizes.chunk}"
    errs = {"fir_decimate": hold_fir_calls("16 mesh ax25", what, calls["fir_decimate"]),
            "symbol_sync_events": hold_events_calls(
                "16 mesh ax25", what, calls["symbol_sync_events_scan"])}
    del calls
    end_phase("16 mesh ax25")

    # ---- phase 13's FM chain streamed on the mesh
    n = sizes.fm_chunk * sizes.fm_chunks
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    si, sq, _ = rtl_fm_iq(n, dev, gen)
    x = torch.complex(si, sq).to(mdev)
    del si, sq
    lpr = np.real(np.asarray(_low_pass_49())).astype(np.float32)

    def fm_blocks():
        return [blocks.FirFilter(lpr, deci=SCAN_TAPS_DECI), blocks.QuadratureDemod(1.0),
                blocks.MultiplyConst(SCAN_GAIN)]

    def fm_run(m, scan):
        """The chain streamed from a fresh graph: (its output, the graph)."""
        g, sink = Graph(), batch_sink()
        g.chain(blocks.VectorSource(x), *fm_blocks(), sink)
        g.run_stream(chunk_size=sizes.fm_chunk, device=mdev, scan_chunks=scan, mesh=m)
        return sink.data(), g

    zero_counts()
    whole = shard_chain(fm_blocks(), mesh)(x)
    counts["fm shard_chain"] = dict(kernels.LAUNCHES)
    outs = {}
    for m, scan, label in ((mesh, None, "mesh"), (mesh, sizes.fm_scan, "mesh batched"),
                           (None, None, "unsharded"),
                           (None, sizes.fm_scan, "unsharded batched")):
        zero_counts()
        outs[label], g = fm_run(m, scan)
        counts[f"fm {label}"] = c = dict(kernels.LAUNCHES)
        print(f"[16 mesh fm] {label} (scan_chunks={scan}): {sizes.fm_chunks} chunks "
              f"of {sizes.fm_chunk}; demotions {g.demotions}; launches "
              f"{json.dumps(c)}; card: {card}")
        if g.demotions:
            failures.append(f"fm {label}: demoted {g.demotions}")
        if on_card and m is not None and (c["fir_decimate"] != n_sh * sizes.fm_chunks
                                          or c["fm_chain"]):
            failures.append(f"fm {label}: launches {c}, want kernel A "
                            f"{n_sh * sizes.fm_chunks} and no kernel B")
        if on_card and m is None and c["fm_chain"] != sizes.fm_chunks:
            failures.append(f"fm {label}: kernel B launched {c['fm_chain']} times")
        require(f"fm {label}", c, ("fir_decimate",) if m is not None else ("fm_chain",))
    got = outs["mesh"]
    k = min(got.shape[0], whole.shape[0])
    unequal = int((got[:k] != whole[:k]).sum())
    print(f"[16 mesh fm] the mesh stream vs shard_chain over the whole stream "
          f"({whole.shape[0]} outputs; launches {json.dumps(counts['fm shard_chain'])}): "
          f"{k} compared, {unequal} not bit-equal; the batched mesh run bit-equal "
          f"to the per-chunk one: {torch.equal(outs['mesh batched'], got)}; "
          f"card: {card}")
    if k < whole.shape[0] - 1 or not torch.equal(outs["mesh batched"], got):
        failures.append("fm mesh: short of shard_chain, or batched != per chunk")
    if on_card and unequal:
        failures.append(f"fm mesh: {unequal} outputs differ from shard_chain")
    elif not on_card:  # the CPU's conv1d rounds a shard apart from the whole
        filt = ops.fir_filter(x, lpr, SCAN_TAPS_DECI)
        report("16 mesh fm", "the mesh stream vs shard_chain (CPU: kernel A's "
               "plain conv1d)", wrapped_err(got[:k], whole[:k], SCAN_GAIN),
               2 * 2e-5 * SCAN_GAIN * envelope_ratio(filt, 0))
    report("16 mesh fm", "the mesh stream (kernel A, exact discriminator) vs the "
           "unsharded stream (kernel B, highest)",
           wrapped_err(got, outs["unsharded"], SCAN_GAIN), BUDGET["highest"])
    del x, whole, outs, got
    end_phase("16 mesh fm")
    return counts, errs


# ---- phase 17: 2-D meshes

@dataclasses.dataclass(frozen=True)
class Mesh2dSizes:
    """Phase 17's sizes: the defaults on the card (phases 15-16's widths);
    a CPU rehearsal (``tests/test_torch_chip_smoke.py``) takes small ones.
    The FM chain runs on the whole main capture given, the receiver on the
    whole corpus given."""

    n_time: int = 2
    n_chan: int = 2
    bank_ch: int = BANK_CH
    bank_n: int = BANK_N
    bank_events: int = BANK_EVENTS
    channels: int = MESH_CHANNELS
    chan_n: int = 1 << 22
    chunk: int = 1 << 18
    frames: int = N_FRAMES
    frame_gate: int = N_FRAMES        # 1000/1000, as the unsharded graph


def same(a, b) -> bool:
    """Bit equality of two tensors, or of two sequences of them (or of
    payloads)."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, bytes):
        return a == b
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def mesh2d_phase(dev, card: str, sizes: Mesh2dSizes, i_main, q_main, audio, want):
    """Phase 17: a (chan, time) mesh of ``sizes.n_chan`` x ``sizes.n_time``
    shards, all on ``dev`` (the one card), at phases 15-16's widths: the
    main capture through the sharded FM chain over ``time``; the
    channelizer bank and the decode bank (both syncs) over ``chan``; the
    corpus ``audio`` streamed through the dense front-end and through
    ``ax25_1200_rx_graph(mesh=)`` over ``time`` (native sync), the latter
    >= the gate and the offline receiver's list ``want``, the front-end
    demoted once at the ragged end.  Each path runs with the counts set to
    0 just before and read just after (on the card kernels A, D and E once
    a shard of every line: every replica line runs), every replica line's
    output equal to the others bit for bit (``Mesh.replicas``),
    and the output equal bit for bit to the same call on a 1-D mesh of
    the axis's size.  Kernels A, D and E are held against their plain
    versions on the 2-D calls' captured arguments.  Returns the launch
    counts of each path and the largest |error| of each kernel held
    here."""
    from rustradio_tpu_torch import ops, parallel, taps as tapgen
    from rustradio_tpu_torch.graph import Graph
    from rustradio_tpu_torch.models import ax25
    from rustradio_tpu_torch.models.multichannel import recover_symbols_batch
    from rustradio_tpu_torch.ops import kernels
    from rustradio_tpu_torch.parallel.graph_mesh import chain_segment

    on_card = dev.type == "cuda"
    mdev = torch.device("cuda", 0) if on_card else dev
    m2 = parallel.make_mesh_2d(sizes.n_time, sizes.n_chan, device=mdev)
    n_sh = sizes.n_time * sizes.n_chan
    one = {a: parallel.make_mesh(m2.shape[a], axis=a, device=mdev)
           for a in ("time", "chan")}
    grid = f"make_mesh_2d({sizes.n_time}, {sizes.n_chan})"
    counts, errs = {}, {}

    def run(name, axis, fn, needs):
        """``fn(m2)`` with the counts set to 0 just before and read just
        after (on the card each kernel of ``needs`` launched exactly its
        count); every replica line along ``axis`` equal bit for bit; then
        ``fn`` on the 1-D mesh of the axis's size, equal bit for bit.
        Returns the 2-D output."""
        zero_counts()
        with m2.replicas() as seen:
            out = fn(m2)
        sync()
        counts[name] = c = dict(kernels.LAUNCHES)
        require(name, c, needs)
        for k, n in needs.items():
            if on_card and c[k] != n:
                failures.append(f"{name}: kernel {k} launched {c[k]} times, not {n}")
        n_lines = n_sh // m2.shape[axis]
        agree = bool(seen) and all(len(e) == n_lines and all(same(t, e[0]) for t in e)
                                   for e in seen)
        equal = same(out, fn(one[axis]))
        print(f"[17 mesh2d] {name} over {axis} of {grid}: launches {json.dumps(c)}; "
              f"{len(seen)} records of {n_lines} replica lines, all lines bit-equal: "
              f"{agree}; bit-equal to the 1-D mesh of {m2.shape[axis]} shards: "
              f"{equal}; card: {card}")
        if not (agree and equal):
            failures.append(f"{name}: replica lines differ, or not the 1-D mesh's")
        return out

    # the FM chain over time: kernel A once a shard of both lines
    iq = torch.complex(i_main, q_main)
    n = iq.shape[0]
    lp = tapgen.low_pass_complex(FS_RTL, 100_000.0, 50_000.0, "hamming")
    y = run("sharded_fm_demod", "time",
            lambda m: parallel.sharded_fm_demod(iq, lp, m, deci=DECI),
            {"fir_decimate": n_sh})
    filt = ops.fir_filter(iq, lp, DECI)
    want_fm = ops.quadrature_demod(filt, 1.0)
    k = min(y.shape[0], want_fm.shape[0])
    if k < want_fm.shape[0] - 1:
        failures.append("mesh2d sharded_fm_demod: short of the offline chain")
    report("17 mesh2d", f"sharded_fm_demod over time of {grid}, 2^{n.bit_length() - 1} "
           f"samples, 49 taps deci 4: {k} outputs vs the offline chain",
           wrapped_err(y[:k], want_fm[:k], 1.0), 2 * 2e-5 * envelope_ratio(filt, 0))
    del y, filt, want_fm
    with capturing("fir_decimate") as calls:
        parallel.sharded_fm_demod(iq, lp, m2, deci=DECI)
    errs["fir_decimate"] = hold_fir_calls(
        "17 mesh2d", f"sharded_fm_demod over time of {grid}", calls["fir_decimate"])
    del calls

    # the channelizer bank over chan: each line's front half, its channels split
    ctaps = parallel.channelizer_taps(sizes.channels)
    xw = iq[: sizes.chan_n]
    got = run("sharded_channelizer_fm", "chan", lambda m: parallel.sharded_channelizer_fm(
        xw, ctaps, sizes.channels, m), {})
    report("17 mesh2d", f"sharded_channelizer_fm over chan of {grid}, {sizes.channels} "
           f"channels of {sizes.chan_n} samples vs channelizer_fm_bank",
           max_err(got, parallel.channelizer_fm_bank(xw, ctaps, sizes.channels)), 1e-5)
    del got

    # the decode bank over chan: kernels E and D once a shard of both lines
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    bank = decode_bank(dev, gen, sizes.bank_ch, sizes.bank_n)
    for method, kernel in (("scan", "symbol_sync_scan"),
                           ("events", "symbol_sync_events")):
        kw = dict(method=method, max_events=sizes.bank_events, return_valid=True)
        got = run(f"sharded_symbol_sync_bank {method}", "chan",
                  lambda m: parallel.sharded_symbol_sync_bank(bank, BANK_SPS, m, **kw),
                  {kernel: n_sh})
        err = max(max_err(a.float(), b.float()) for a, b in zip(
            got, recover_symbols_batch(bank, BANK_SPS, **kw)))
        report("17 mesh2d", f"sharded_symbol_sync_bank {method} over chan of {grid}, "
               f"{sizes.bank_ch} x {sizes.bank_n} vs the unsharded call", err, 0.0)
    with capturing("symbol_sync_scan", "symbol_sync_events_scan") as calls:
        for method in ("scan", "events"):
            parallel.sharded_symbol_sync_bank(bank, BANK_SPS, m2, method=method,
                                              max_events=sizes.bank_events)
    errs["symbol_sync_scan"] = hold_scan_calls(
        "17 mesh2d", f"sharded_symbol_sync_bank scan over chan of {grid}",
        calls["symbol_sync_scan"], window=1 << 12)
    errs["symbol_sync_events"] = hold_events_calls(
        "17 mesh2d", f"sharded_symbol_sync_bank events over chan of {grid}",
        calls["symbol_sync_events_scan"])
    del got, calls
    end_phase("17 mesh2d one shot")

    # the corpus streamed over time: the dense front-end's stream, then the
    # whole receiver (native sync)
    audio = torch.as_tensor(audio).to(mdev)
    n_a = audio.shape[0]
    chunks = -(-n_a // sizes.chunk)
    front_nodes = ax25_receiver(audio, "native", 6)[0].nodes[1:6]
    front = chain_segment([nd.block for nd in front_nodes], m2)
    last = n_a - (chunks - 1) * sizes.chunk
    want_dem = ([chunks - 1] if last % (m2.shape["time"] * front.div)
                or last < front.min_chunk else [])
    want_a = 3 * n_sh * (chunks - len(want_dem)) + 3 * len(want_dem)

    def front_stream(m):
        g, sink = ax25_receiver(audio, "native", 6, batch_sink())
        g.run_stream(chunk_size=sizes.chunk, device=mdev, mesh=m)
        return sink.data(), [d["chunk"] for d in g.demotions]

    dem = {}

    def front_data(m):
        data, dem[m.grid] = front_stream(m)
        return data

    front_out = run("ax25 front-end streamed", "time", front_data, {"fir_decimate": want_a})
    if dem[m2.grid] != want_dem or dem[(m2.shape["time"],)] != want_dem:
        failures.append(f"mesh2d front-end: demoted at {dem}, want {want_dem}")
    plain = front_stream(None)[0]
    unequal = int((front_out != plain).sum()) if front_out.shape == plain.shape else -1
    print(f"[17 mesh2d] the front-end over time of {grid}: {front_out.shape[0]} outputs "
          f"in {chunks} chunks of {sizes.chunk}, demoted at chunks {dem[m2.grid]} "
          f"(want {want_dem}); {unequal} not bit-equal to the unsharded stream; "
          f"card: {card}")
    del plain

    def receiver(m):
        got_l, g = graph_of(lambda: decoded(ax25.ax25_1200_rx_graph(
            audio, FS_AUDIO, m, chunk_size=sizes.chunk), sizes.frames))
        dem[m.grid] = [d["chunk"] for d in g.demotions
                       if d["segment"] == Graph._unit_name(front_nodes)]
        return got_l

    got_l = run("ax25_1200_rx_graph", "time", receiver, {"fir_decimate": want_a})
    print(f"[17 mesh2d] ax25_1200_rx_graph over time of {grid}, chunks of {sizes.chunk}: "
          f"{len(set(got_l))}/{sizes.frames} decoded, the offline receiver's list: "
          f"{got_l == want}; the front-end demoted at chunks {dem[m2.grid]}; card: {card}")
    if len(set(got_l)) < sizes.frame_gate or got_l != want or dem[m2.grid] != want_dem:
        failures.append(f"mesh2d receiver: {len(set(got_l))} frames, another list, or "
                        f"demoted at {dem[m2.grid]}")
    end_phase("17 mesh2d streamed")
    return counts, errs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need an NVIDIA GPU", file=sys.stderr)
        return 1
    from rustradio_tpu_torch.ops import cuda_lib

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---- 1. environment
    nvcc = subprocess.run([cuda_lib._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    card = card_line()
    print(f"[1 env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count "
          f"{torch.cuda.device_count()}")
    print(f"[1 env] nvcc: {nvcc}")
    print(f"[1 env] card: {card}")

    # ---- 2. build
    cuda_lib.load()
    print(f"[2 build] {cuda_lib.BUILD_INFO['path']} "
          f"cached={cuda_lib.BUILD_INFO['cached']}")

    sizes = CoreSizes()
    # ---- 3 and 3e. kernels A, B and C against their plain versions
    errs, cap = kernels_phase(dev, card, sizes, gen)
    i_main, q_main, phase = cap["i_main"], cap["q_main"], cap["phase"]

    # ---- 4 and 5. the FM path, counted: the models and the Graph device loop
    launches = fm_phase(dev, card, sizes, gen, cap)

    # ---- 6. the AX.25 1200 bd path, counted
    audio, iq_np, got, ax_counts, iq_counts = ax25_phase(dev, card, sizes)

    # ---- 7. the discriminator op path, counted
    op_counts = op_phase(dev, card, cap)

    # ---- 9. clock recovery (kernels D and E), the wideband receiver and
    # the channelizer (kernel H)
    sync_errs, ev_got, ev_counts, wb_counts = sync_phase(
        dev, card, sizes, gen, audio, got)
    errs.update(sync_errs)

    # ---- 10. the FM family's apps and the streaming Graph, counted
    apps, call_errs = apps_phase(dev, card, AppsSizes(), i_main, q_main, audio,
                                 {"native": got, "events": ev_got})
    for name, err in call_errs.items():
        errs[name] = max(errs[name], err)

    # ---- 11. the G3RUH modem and the burst receivers, counted
    g3_counts, call_errs = burst_phase(dev, card, BurstSizes())
    for name, err in call_errs.items():
        errs[name] = max(errs[name], err)
    apps.update({f"11 {k}": v for k, v in g3_counts.items()})

    # ---- 12. the radio-facing receivers, counted
    radio_counts, call_errs = radio_phase(dev, card, RadioSizes(),
                                          audio.cpu().numpy(), iq_np)
    for name, err in call_errs.items():
        errs[name] = max(errs[name], err)
    apps.update({f"12 {k}": v for k, v in radio_counts.items()})

    # ---- 13. the batched streaming runner, the Graph's trace and costs,
    # and the generators, counted
    scan_counts, call_errs = scan_phase(dev, card, ScanSizes(), i_main, q_main,
                                        audio, {"native": got, "events": ev_got})
    for name, err in call_errs.items():
        errs[name] = max(errs[name], err)
    apps.update({f"13 {k}": v for k, v in scan_counts.items()})

    # ---- 14. the recurrences (kernels F and G) and the live feeds, counted
    live_counts, call_errs = live_phase(dev, card, LiveSizes(), phase, i_main,
                                        q_main)
    for name, err in call_errs.items():
        errs[name] = max(errs.get(name, 0.0), err)
    apps.update({f"14 {k}": v for k, v in live_counts.items()})

    # ---- 15. the multi-device layer, one shot: 4 shards on the card, counted
    mesh_counts, call_errs = mesh_phase(dev, card, MeshSizes(), i_main, q_main,
                                        audio, got)
    for name, err in call_errs.items():
        errs[name] = max(errs.get(name, 0.0), err)
    apps.update({f"15 {k}": v for k, v in mesh_counts.items()})

    # ---- 16. the multi-device layer, streamed: 4 shards on the card, counted
    stream_counts, call_errs = mesh_stream_phase(dev, card, MeshStreamSizes(), audio)
    for name, err in call_errs.items():
        errs[name] = max(errs.get(name, 0.0), err)
    apps.update({f"16 {k}": v for k, v in stream_counts.items()})

    # ---- 17. 2-D meshes: a (chan, time) mesh of 2 x 2 shards on the card, counted
    mesh2d_counts, call_errs = mesh2d_phase(dev, card, Mesh2dSizes(), i_main,
                                            q_main, audio, got)
    for name, err in call_errs.items():
        errs[name] = max(errs.get(name, 0.0), err)
    apps.update({f"17 {k}": v for k, v in mesh2d_counts.items()})

    def total(name, prefix=""):
        return sum(c[name] for k, c in apps.items() if k.startswith(prefix))

    def entry(name, source, replaces, n_launches):
        """One kernel of the record: its launches on its paths and its
        largest |error| against its plain version."""
        return {"name": name, "route": "cuda",
                "source": f"rustradio_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": errs[name]}

    record = {"kernels": [
        entry("fir_decimate", "fir_decimate.cu",
              "rustradio_tpu/ops/pallas_kernels.py:202",
              launches["fir_decimate"] + ax_counts["fir_decimate"]
              + iq_counts["fir_decimate"] + total("fir_decimate")),
        entry("fm_chain", "fm_chain.cu",
              "rustradio_tpu/ops/pallas_kernels.py:394,448,553",
              launches["fm_chain"] + total("fm_chain")),
        entry("quad_demod", "quad_demod.cu",
              "rustradio_tpu/ops/pallas_kernels.py:91",
              op_counts["quad_demod"]),
        entry("symbol_sync_events", "symbol_sync.cu",
              "rustradio_tpu/ops/symbol_sync.py:305",
              ev_counts["symbol_sync_events"]
              + wb_counts["events"]["symbol_sync_events"]
              + total("symbol_sync_events")),
        entry("symbol_sync_scan", "symbol_sync.cu",
              "rustradio_tpu/ops/symbol_sync.py:145",
              wb_counts["scan"]["symbol_sync_scan"] + total("symbol_sync_scan")),
        entry("cma", "cma.cu", "rustradio_tpu/ops/cma.py:45", total("cma")),
        entry("iir", "iir.cu", "rustradio_tpu/ops/iir.py:68", total("iir")),
        entry("pfb_channelize", "pfb_channelize.cu", None,
              sum(c["pfb_channelize"] for c in wb_counts.values())
              + total("pfb_channelize")),
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
