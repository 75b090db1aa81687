"""AX.25 1200 bd Bell-202 AFSK receiver (port of the 1200 bd part of
``rustradio_tpu/models/ax25.py``).

Mirrors the reference's flagship app, examples/ax25-1200-rx.rs:229-315:
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
from ..ops import fir, hdlc, hilbert, nrzi, resampler
from ..ops.fft_filter import filter_complex, filter_float
from ..ops.elementwise import add_const, binary_slicer
from ..ops.symbol_sync import compact, recover_symbols, symbol_sync_events

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
    chunk_size: int | None = None,
    fix_bits: bool = False,
    symbol_taps=(1 / 6,) * 6,
    symbol_max_deviation: float = 0.5,
    keep_checksum: bool = False,
    band: tuple | None = (400.0, 2700.0),
    sync: str = "native",
    device=None,
) -> list[bytes]:
    """The receiver of :func:`ax25_1200_rx` as a BLOCK flowgraph, run by
    the Graph runners: the reference's own structure
    (examples/ax25-1200-rx.rs:209-253 connects the chain as blocks).

    VectorSource -> [FftFilterFloat band-pass] -> Hilbert -> QuadratureDemod
    -> FftFilterFloat low-pass -> AddConst (the dense front-end, one device
    segment: kernel A) -> SymbolSync (``sync``: "native" on the host,
    "events" on kernel D) -> BinarySlicer -> NrziDecode -> HdlcDeframer ->
    PduVectorSink.  ``chunk_size`` selects ``Graph.run_stream``, else
    ``Graph.run``.  ``audio`` is a tensor (the graph runs on its device) or
    a numpy array with ``device=``.  An unknown ``sync`` raises.  Returns
    the decoded payloads as bytes.
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
        g.run_stream(chunk_size=chunk_size, device=audio.device)
    else:
        g.run(device=audio.device)
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
