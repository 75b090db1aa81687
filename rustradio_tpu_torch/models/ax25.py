"""AX.25 receivers: 1200 bd Bell 202 AFSK and 9600 bd G3RUH, with the
burst receivers on whole-packet clock recovery, the G3RUH transmitter and
the IL2P 1200 bd receiver (port of ``rustradio_tpu/models/ax25.py``).

``ax25_1200_rx`` mirrors the reference's flagship app,
examples/ax25-1200-rx.rs:229-315:
Hilbert(65, Hamming) -> QuadratureDemod(1.0) -> FftFilterFloat(low_pass(fs,
1100, ...)) -> add_const(-2*pi*1700/fs) -> SymbolSync(fs/1200, ...) ->
BinarySlicer -> NrziDecode -> HdlcDeframer(10, 1500), with the JAX
package's 400-2700 Hz input band-pass in front.

The dense front-end (filters, demod) runs on the input's device: every FIR
on ``kernels.fir_decimate`` (kernel A on the card), the IQ channel filter
by overlap-save FFT when it is longer than ``kernels.MAX_TAPS``.  Clock
recovery runs either on the host over the NRZ stream copied back
(``sync="native"``, native ``rr_symbol_sync``) or on the device
(``sync="events"``, ``symbol_sync_events`` on kernel D), which copies back
only the symbols; NRZI and HDLC run on the host.

``ax25_1200_rx_graph`` is the same receiver built from blocks and run by
the Graph runners (offline, or streamed in chunks).

``ax25_9600_rx`` (examples/ax25-9600-rx.rs:136-207): a 12.5 kHz channel
filter, resampling to 50 kHz, the discriminator, then the same clock
recovery (``sync``), slicer, NRZI, G3RUH descrambler and HDLC.  The burst
receivers ``ax25_1200_wpcr_rx`` and ``ax25_9600_wpcr_rx``
(examples/ax25-{1200,9600}-wpcr.rs) gate the stream on its power, cut the
bursts (``ops.stream_to_pdu``) and recover each burst's clock with one
batched ``ops.wpcr_batch`` on the device.  ``g3ruh_modulate`` is the TX
half of examples/g3ruh.rs.  ``il2p_1200_rx`` (examples/il2p-1200-rx.rs)
takes the IQ front-end and the Bell-202 demod of ``ax25_1200_rx``, the
native clock recovery, the slicer inverted, and the IL2P header hunt.

Inputs: a tensor stays on its device; a numpy array goes to the ``device``
the caller names (there is no default device).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import taps as tapgen
from ..ops import demod as demod_ops
from .._device import target_device
from ..ops import fir, hdlc, hilbert, iir, nrzi, resampler
from ..ops.burst import burst_tagger, stream_to_pdu
from ..ops.elementwise import add_const, binary_slicer, complex_to_mag2
from ..ops.fft_filter import filter_complex, filter_float
from ..ops.il2p import Il2pHeader, il2p_deframe
from ..ops.scramble import descramble, scramble
from ..ops.symbol_sync import compact, recover_symbols, symbol_sync_events
from ..ops.vco import vco
from ..ops.wpcr import wpcr_batch

DEMODS = ("discriminator", "tones")
_NP_DTYPE = {torch.float32: np.float32, torch.complex64: np.complex64}


@dataclasses.dataclass
class Ax25Packet:
    """One decoded AX.25 frame.

    CRC checked and stripped, unless decoded with ``keep_checksum=True``
    (structural recovery) — then ``data`` keeps the 2 unverified CRC bytes.
    """

    data: np.ndarray  # payload bytes, CRC stripped
    bit_pos: int  # bit-stream position of the frame end

    def __bytes__(self) -> bytes:
        return bytes(self.data)

    @property
    def addresses(self):
        return parse_ax25(self.data)[0]

    @property
    def info(self):
        return parse_ax25(self.data)[1]


def parse_ax25(frame: np.ndarray):
    """Minimal AX.25 UI-frame parse: (dest, src via callsigns), info bytes."""
    frame = np.asarray(frame, np.uint8)
    if len(frame) < 16:
        return [], b""
    addrs = []
    i = 0
    while i + 7 <= len(frame):
        chunk = frame[i : i + 7]
        call = "".join(chr(c >> 1) for c in chunk[:6]).strip()
        ssid = (chunk[6] >> 1) & 0xF
        addrs.append(f"{call}-{ssid}" if ssid else call)
        last = chunk[6] & 1
        i += 7
        if last:
            break
    info = bytes(frame[i + 2 :]) if i + 2 <= len(frame) else b""
    return addrs, info


def _stream(x, dtype, device) -> torch.Tensor:
    """A tensor stays on its device; numpy goes to ``device``."""
    if torch.is_tensor(x):
        return x.to(dtype)
    if device is None:
        raise ValueError("a numpy input needs device= (e.g. 'cuda' or 'cpu')")
    return torch.from_numpy(np.ascontiguousarray(x, _NP_DTYPE[dtype])).to(device)


SYNCS = ("native", "events")


def _check_modes(demod: str, sync: str) -> None:
    if sync not in SYNCS:
        raise ValueError(f"unknown sync {sync!r}; use 'native' or 'events'")
    if demod not in DEMODS:
        raise ValueError(f"unknown demod {demod!r}; use one of {DEMODS}")


def bell202_demod(audio, samp_rate: float,
                  band: tuple | None = (400.0, 2700.0),
                  device=None) -> torch.Tensor:
    """Dense part of the Bell-202 AFSK demod: f32 audio -> NRZ floats, on
    the audio's device (a numpy input goes to ``device``).

    Band-pass -> Hilbert -> quad demod -> 1100 Hz low-pass ->
    centre-frequency offset (reference chain examples/ax25-1200-rx.rs:
    229-247, which has NO input band-pass).  The 400-2700 Hz band-pass and
    the 200 Hz low-pass transition are the JAX package's swept defaults;
    ``band=None`` restores the reference-faithful chain (100 Hz
    transition).
    """
    audio = _stream(audio, torch.float32, device)
    if band is not None:
        bp = tapgen.band_pass(samp_rate, band[0], band[1], 65, "hamming")
        audio = filter_float(audio, bp)
    lp = tapgen.low_pass(samp_rate, 1100.0, 200.0 if band is not None else 100.0,
                         "hamming")
    analytic = hilbert.hilbert_transform(audio, 65, "hamming")
    fm = demod_ops.quadrature_demod(analytic, 1.0)
    filt = filter_float(fm, lp)
    center = 1700.0  # (1200 + 2200) / 2
    return add_const(filt, -float(np.float32(2.0 * np.pi * center / samp_rate)))


def bell202_tone_demod(audio, samp_rate: float, device=None) -> torch.Tensor:
    """Dual-tone correlator AFSK demod: f32 audio -> NRZ floats, on the
    audio's device (a numpy input goes to ``device``).

    Mixes the audio against both Bell-202 tones and compares their energies
    over a one-symbol moving average (``fir.fir_filter_full``, kernel A on
    the card).  No reference equivalent.
    """
    audio = _stream(audio, torch.float32, device)
    fs = float(samp_rate)
    n32 = torch.arange(audio.shape[0], dtype=torch.int32, device=audio.device)
    w = int(fs / 1200.0)
    k = np.ones(w, np.float32) / w
    pad = (w - 1) // 2

    def tone_energy(f):
        # the phase index modulo the tone's period keeps the f32 phase small
        if fs == int(fs) and f == int(f):
            idx = (n32 % (int(fs) // math.gcd(int(f), int(fs)))).float()
        else:
            idx = n32.float()
        ph = idx * float(np.float32(2.0 * np.pi * f / fs))
        re = audio * torch.cos(ph)
        im = audio * -torch.sin(ph)
        # centered moving average == np.convolve(..., 'same')
        er = fir.fir_filter_full(F.pad(re, (0, pad)), k)[pad:]
        ei = fir.fir_filter_full(F.pad(im, (0, pad)), k)[pad:]
        return er * er + ei * ei

    e_mark = tone_energy(1200.0)
    e_space = tone_energy(2200.0)
    return (e_space - e_mark) / (e_space + e_mark + 1e-9)


def ax25_1200_rx(
    audio,
    samp_rate: float,
    fix_bits: bool = False,
    symbol_taps=(1 / 6,) * 6,
    symbol_max_deviation: float = 0.5,
    demod: str = "discriminator",
    keep_checksum: bool = False,
    band: tuple | None = (400.0, 2700.0),
    sync: str = "native",
    device=None,
) -> list[Ax25Packet]:
    """Decode AX.25 packets from Bell-202 AFSK audio (float32 stream).

    ``demod``: "discriminator" (the reference chain + an input band-pass,
    see :func:`bell202_demod`) or "tones" (the dual-tone correlator).
    ``band=None`` restores the reference-faithful discriminator input.
    ``sync``: "native" (the sequential host recurrence, bit-exact with the
    JAX package's) or "events" (the event-driven device form on kernel D,
    decode-equivalent; see ``ops.symbol_sync.symbol_sync_events``).
    ``audio`` is a tensor (it stays on its device) or a numpy array with
    ``device=``.
    """
    _check_modes(demod, sync)
    audio = _stream(audio, torch.float32, device)
    if demod == "tones":
        nrz = bell202_tone_demod(audio, float(samp_rate))
    else:
        nrz = bell202_demod(audio, float(samp_rate), band)
    sps = float(samp_rate) / 1200.0
    if sync == "events":
        (vals, mask, _), _valid = symbol_sync_events(
            nrz, sps, symbol_max_deviation, tuple(symbol_taps))
        symbols = compact(vals, mask)  # stays on the device
    else:
        symbols = torch.from_numpy(recover_symbols(
            nrz, sps, symbol_max_deviation, symbol_taps))
    bits = nrzi.nrzi_decode(binary_slicer(symbols))
    packets, _ = hdlc.hdlc_deframe(bits, 10, 1500, keep_checksum=keep_checksum,
                                   fix_bits=fix_bits)
    return [Ax25Packet(np.asarray(d), int(p)) for d, p in packets]


def ax25_1200_rx_graph(
    audio,
    samp_rate: float,
    mesh=None,
    chunk_size: int | None = None,
    fix_bits: bool = False,
    symbol_taps=(1 / 6,) * 6,
    symbol_max_deviation: float = 0.5,
    keep_checksum: bool = False,
    band: tuple | None = (400.0, 2700.0),
    sync: str = "native",
    device=None,
    scan_chunks: int | None = None,
) -> list[bytes]:
    """The receiver of :func:`ax25_1200_rx` as a BLOCK flowgraph, run by
    the Graph runners: the reference's own structure
    (examples/ax25-1200-rx.rs:209-253 connects the chain as blocks).

    VectorSource -> [FftFilterFloat band-pass] -> Hilbert -> QuadratureDemod
    -> FftFilterFloat low-pass -> AddConst (the dense front-end, one device
    segment: kernel A) -> SymbolSync (``sync``: "native" on the host,
    "events" on kernel D) -> BinarySlicer -> NrziDecode -> HdlcDeframer ->
    PduVectorSink.  ``chunk_size`` selects ``Graph.run_stream`` (batched
    with ``scan_chunks``: the front-end segment one CUDA-graph replay a
    batch on the card), else ``Graph.run``.  ``mesh=`` (a
    ``parallel.Mesh`` starting on the audio's device; on a (chan, time)
    mesh the front-end shards over ``time``) is the reference's
    ``MTGraph`` flag (examples/ax25-1200-rx.rs:209-213): the dense
    front-end runs as one mesh segment with the sample axis sharded,
    offline or streamed (a ragged last chunk demotes it), under
    ``scan_chunks`` too; the clock recovery and the tail run unsharded.
    ``audio`` is a tensor (the graph runs on its device) or a numpy array
    with ``device=``.  An unknown ``sync`` raises.  Returns the decoded
    payloads as bytes.
    """
    from .. import blocks
    from ..graph import Graph

    _check_modes("discriminator", sync)
    audio = _stream(audio, torch.float32, device)
    g = Graph()
    sink = blocks.PduVectorSink()
    chain = [blocks.VectorSource(audio)]
    if band is not None:
        chain.append(blocks.FftFilterFloat(
            tapgen.band_pass(samp_rate, band[0], band[1], 65, "hamming")))
    lp = tapgen.low_pass(samp_rate, 1100.0, 200.0 if band is not None else 100.0,
                         "hamming")
    chain += [
        blocks.Hilbert(65),
        blocks.QuadratureDemod(1.0),
        blocks.FftFilterFloat(lp),
        blocks.AddConst(-float(np.float32(2.0 * np.pi * 1700.0 / samp_rate))),
        blocks.SymbolSync(float(samp_rate) / 1200.0, symbol_max_deviation,
                          tuple(symbol_taps), method=sync),
        blocks.BinarySlicer(),
        blocks.NrziDecode(),
        blocks.HdlcDeframer(10, 1500, fix_bits, keep_checksum),
        sink,
    ]
    g.chain(*chain)
    if chunk_size:
        g.run_stream(chunk_size=chunk_size, device=audio.device,
                     scan_chunks=scan_chunks, mesh=mesh)
    else:
        g.run(device=audio.device, mesh=mesh)
    return [bytes(np.asarray(p.data)) for p in sink.pdus()]


def _channel_fm(iq: torch.Tensor, samp_rate, new_rate, cutoff, twidth,
                fast_fm=False) -> torch.Tensor:
    """Channel low-pass -> resample -> FM demod."""
    lp = tapgen.low_pass_complex(samp_rate, cutoff, twidth, "hamming")
    x = filter_complex(iq, lp)
    x = resampler.rational_resampler(x, int(new_rate), int(samp_rate))
    if fast_fm:
        return demod_ops.fast_fm(x)
    return demod_ops.quadrature_demod(x, 1.0)


def iq_front_end(iq, samp_rate: float, new_rate: float = 50_000.0,
                 fast_fm: bool = False, device=None) -> torch.Tensor:
    """Complex IQ -> FM-demodulated floats at ``new_rate``
    (examples/ax25-1200-rx.rs:163-188): a 20 kHz / 100 Hz channel low-pass,
    the rational resampler, then the discriminator (or FastFM)."""
    return _channel_fm(_stream(iq, torch.complex64, device), float(samp_rate),
                       float(new_rate), 20_000.0, 100.0, bool(fast_fm))


def ax25_1200_rx_iq(iq, samp_rate: float, device=None,
                    **kw) -> list[Ax25Packet]:
    """Decode AX.25 1200 bd from complex IQ (FM carrier); ``kw`` go to
    :func:`ax25_1200_rx`."""
    _check_modes(kw.get("demod", "discriminator"), kw.get("sync", "native"))
    audio = iq_front_end(iq, samp_rate, device=device)
    return ax25_1200_rx(audio, 50_000.0, **kw)


def il2p_1200_rx(iq, samp_rate: float, symbol_taps=(0.5, 0.5),
                 symbol_max_deviation: float = 0.5,
                 device=None) -> list[Il2pHeader]:
    """IL2P 1200 bd AFSK receiver (reference examples/il2p-1200-rx.rs:57-146):
    the IQ front-end to 50 kHz (kernel A on the card), the Bell-202 demod
    (kernel A), native clock recovery on the host, the slicer inverted
    (examples/il2p-1200-rx.rs:122), then the IL2P sync hunt and header
    decode.  ``iq`` is a tensor (it stays on its device) or a numpy array
    with ``device=``.  Returns a list of ``Il2pHeader``."""
    new_rate = 50_000.0
    fm = iq_front_end(iq, samp_rate, new_rate, device=device)
    nrz = bell202_demod(fm, new_rate)
    syms = recover_symbols(nrz, new_rate / 1200.0, symbol_max_deviation,
                           symbol_taps)
    return il2p_deframe(binary_slicer(torch.from_numpy(syms)) ^ 1)


def _clock_recovery(nrz: torch.Tensor, sps: float, max_deviation: float,
                    taps, sync: str) -> torch.Tensor:
    """The recovered symbols: on the device (``sync="events"``, kernel D,
    only the symbols leave it) or on the host (native)."""
    if sync == "events":
        (vals, mask, _), _valid = symbol_sync_events(
            nrz, sps, max_deviation, tuple(taps))
        return compact(vals, mask)
    return torch.from_numpy(recover_symbols(nrz, sps, max_deviation, taps))


def _packets(bits, fix_bits: bool) -> list[Ax25Packet]:
    packets, _ = hdlc.hdlc_deframe(bits, 10, 1500, fix_bits=fix_bits)
    return [Ax25Packet(np.asarray(d), int(p)) for d, p in packets]


def ax25_9600_rx(
    iq,
    samp_rate: float,
    new_rate: float = 50_000.0,
    baud: float = 9600.0,
    symbol_taps=(0.0001, 0.99999999),
    symbol_max_deviation: float = 0.1,
    fix_bits: bool = False,
    sync: str = "native",
    device=None,
) -> list[Ax25Packet]:
    """AX.25 9600 bd G3RUH receiver, traditional symbol-sync path
    (reference examples/ax25-9600-rx.rs:136-207): 12.5 kHz channel filter ->
    resample to ``new_rate`` -> FM demod -> SymbolSync(zero-crossing TED,
    clamped IIR clock filter) -> slicer -> NRZI -> G3RUH descramble -> HDLC.
    ``sync`` as in :func:`ax25_1200_rx` (an unknown one raises before any
    work).  ``iq`` is a tensor (it stays on its device) or a numpy array
    with ``device=``."""
    _check_modes("discriminator", sync)
    nrz = _channel_fm(_stream(iq, torch.complex64, device), float(samp_rate),
                      float(new_rate), 12_500.0, 100.0)
    syms = _clock_recovery(nrz, float(new_rate) / baud, symbol_max_deviation,
                           symbol_taps, sync)
    bits = descramble(nrzi.nrzi_decode(binary_slicer(syms)))
    return _packets(bits, fix_bits)


def _burst_front(iq: torch.Tensor, samp_rate, new_rate, cutoff, iir_alpha):
    """Burst front-end: channel filter + resample, emitting the power
    envelope (for the burst gate) and the FM discriminator output."""
    lp = tapgen.low_pass_complex(samp_rate, cutoff, 100.0, "hamming")
    x = filter_complex(iq, lp)
    x = resampler.rational_resampler(x, int(new_rate), int(samp_rate))
    power = iir.single_pole_iir(complex_to_mag2(x), iir_alpha)
    return power, demod_ops.quadrature_demod(x, 1.0)


def _afsk_discriminator(fm: torch.Tensor, samp_rate, cutoff) -> torch.Tensor:
    """FM floats -> AFSK tone discriminator output: Hilbert, a second
    discriminator, low-pass (examples/ax25-1200-wpcr.rs:105-120)."""
    analytic = hilbert.hilbert_transform(fm, 65, "hamming")
    afsk = demod_ops.quadrature_demod(analytic, 1.0)
    lp = tapgen.low_pass(samp_rate, cutoff, 100.0, "hamming")
    return filter_float(afsk, lp)


def _burst_bits(power, data, threshold, max_size, tail, descrambled):
    """Gate ``data`` on ``power``, cut the bursts, recover each one's clock
    (one ``wpcr_batch`` on the device) and return each found burst's bits
    on the host: sliced, NRZI-decoded and, for G3RUH, descrambled."""
    n = min(int(data.shape[0]), int(power.shape[0]))
    start, end = burst_tagger(power[:n], threshold)
    bursts = stream_to_pdu(data[:n], start, end, max_size, tail)
    found = [syms for syms, info in wpcr_batch(bursts) if info["found"]]
    if not found:
        return []
    # one slicer pass and one copy to the host for every burst's symbols
    bits = binary_slicer(torch.cat(found)).cpu()
    out = []
    for b in torch.split(bits, [len(s) for s in found]):
        b = nrzi.nrzi_decode(b)
        out.append(descramble(b) if descrambled else b)
    return out


def ax25_1200_wpcr_rx(
    iq,
    samp_rate: float,
    new_rate: float = 50_000.0,
    iir_alpha: float = 0.01,
    threshold: float = 0.0001,
    tail: int = 50,
    fix_bits: bool = False,
    device=None,
) -> list[Ax25Packet]:
    """AX.25 1200 bd AFSK burst receiver with whole-packet clock recovery
    (reference examples/ax25-1200-wpcr.rs:45-135): channel filter -> resample
    -> FM demod -> Hilbert -> second FM demod (AFSK tone discriminator) ->
    2.4 kHz low-pass -> power-gated burst capture -> Midpointer -> WPCR ->
    slicer -> NRZI -> HDLC (no descrambler at 1200 bd).  ``iq`` is a tensor
    (it stays on its device) or a numpy array with ``device=``."""
    power, fm = _burst_front(_stream(iq, torch.complex64, device),
                             float(samp_rate), float(new_rate), 20_000.0,
                             float(iir_alpha))
    nrz = _afsk_discriminator(fm, float(new_rate), 2400.0)
    packets: list[Ax25Packet] = []
    for bits in _burst_bits(power, nrz, threshold, int(new_rate), tail, False):
        packets += _packets(bits, fix_bits)
    return packets


def ax25_9600_wpcr_rx(
    iq,
    samp_rate: float,
    new_rate: float = 50_000.0,
    iir_alpha: float = 0.01,
    threshold: float = 0.0001,
    max_burst: int = 50_000,
    tail: int = 50,
    fix_bits: bool = False,
    device=None,
) -> list[Ax25Packet]:
    """AX.25 9600 bd G3RUH burst receiver with whole-packet clock recovery
    (examples/ax25-9600-wpcr.rs:93-142): the burst front-end, then per
    burst Midpointer -> WPCR -> slicer -> NRZI -> G3RUH descrambler ->
    HDLC.  ``iq`` is a tensor (it stays on its device) or a numpy array with
    ``device=``."""
    power, demod = _burst_front(_stream(iq, torch.complex64, device),
                                float(samp_rate), float(new_rate), 20_000.0,
                                float(iir_alpha))
    packets: list[Ax25Packet] = []
    for bits in _burst_bits(power, demod, threshold, max_burst, tail, True):
        packets += _packets(bits, fix_bits)
    return packets


def g3ruh_modulate(
    frames,
    sample_rate: float,
    baud: float = 9600.0,
    if_rate: float = 48_000.0,
    deviation: float = 3000.0,
    amplitude: float = 0.5,
    device="cuda",
) -> torch.Tensor:
    """G3RUH FSK transmitter (the TX half of reference examples/g3ruh.rs:
    246-289): HDLC frame -> G3RUH scramble -> NRZI -> upsample to IF rate ->
    bits to +/-deviation -> VCO -> amplitude -> resample to RF rate ->
    8.8 kHz channel low-pass.  Returns complex64 baseband on ``device``:
    the card unless the caller names another (without a card the default
    raises)."""
    device = target_device(device, "g3ruh_modulate")
    chunks = []
    for frame in frames:
        chunks.append(hdlc.hdlc_frame(hdlc.fcs_add(np.asarray(frame, np.uint8))))
        # Inter-frame idle; also flushes the scrambler register (its output
        # is the input delayed by length+1 = 17 clocks).
        chunks.append(np.zeros(max(17, int(baud * 0.05)), np.uint8))
    if not chunks:
        return torch.zeros(0, dtype=torch.complex64, device=device)
    bits = torch.from_numpy(np.concatenate(chunks)).to(device)
    # one continuous LFSR over the whole stream, like the reference's
    # streaming Scrambler block
    scrambled, _ = scramble(bits)
    line = nrzi.nrzi_encode(scrambled).to(torch.float32)
    line = resampler.rational_resampler(line, int(if_rate), int(baud))
    pn = torch.where(line > 0, float(deviation), -float(deviation))
    return _g3ruh_shape(pn, float(sample_rate), float(if_rate), float(amplitude))


def _g3ruh_shape(pn: torch.Tensor, sample_rate, if_rate, amplitude):
    """VCO + gain + RF resample + 8.8 kHz channel filter."""
    iq, _ = vco(pn, 2.0 * np.pi / if_rate)
    iq = iq * float(np.float32(amplitude))
    iq = resampler.rational_resampler(iq, int(sample_rate), int(if_rate))
    lp = tapgen.low_pass_complex(sample_rate, 8_800.0, 1_000.0, "hamming")
    return filter_complex(iq, lp)
