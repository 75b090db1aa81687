"""Device time of kernels D and E alone beside their one-thread yardsticks,
and the card's latencies between dependent operations, on one NVIDIA GPU.

    python -m rustradio_tpu_torch.tools.time_sync [label]

Shapes are those of the port's paths: kernel D on one channel of 3,577,021
slots (the AX.25 corpus at 24 kHz, sps 20, 6 clock taps), on 8 x 131,072
slots (the wideband capture's active channels, sps 26.667) and on 64 x 7133
(the decode bank, sps 36.75); kernel E on 8 x 487,227, 64 x 2^16 and 64 x
2^12 samples.  Inputs are noisy NRZ made on the card from a seed.  Each
time is the median of 5 replays of a CUDA graph of a few calls, in ms per
call, the block-per-channel kernel and the one-thread form
(tools/csrc/symbol_sync_lone.cu) in turns; their outputs are compared bit
for bit first.  Kernel D is timed both with each channel's count of
crossing slots handed over, as ``ops.symbol_sync_events`` calls it, and
without (the loader then finds the padding).  The calibration
(tools/csrc/chain_calib.cu) gives the cycles of one link of a dependent
chain of f32 additions, of IEEE divisions, of add-compare-subtract steps
and of additions with a taken branch each on a lone lane, and the SM clock
under that load.  Prints one JSON line.

The two yardstick sources are no part of the package's kernel library:
this module builds them at first use into a library of its own
(``_build/librr_yardsticks_<hash>.so``, a few seconds of nvcc).
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import _buildcache
from ..ops import cuda_lib, kernels
from . import sync_cases
from .time_fir import graph_ms

YARDSTICK_DIR = Path(__file__).resolve().parent / "csrc"

SHAPES_D = (  # channels, samples, slots, sps, clock taps
    (1, 14_308_087, 3_577_021, 20.0, (1 / 6,) * 6),
    (8, 487_227, 131_072, 26.667, (0.5, 0.5)),
    (64, 1 << 16, 7133, 36.75, (0.5, 0.5)),
)
SHAPES_E = (  # channels, samples, sps, clock taps
    (8, 487_227, 26.667, (0.5, 0.5)),
    (64, 1 << 16, 36.75, (0.5, 0.5)),
    (64, 1 << 12, 36.75, (0.5, 0.5)),
)
CALIB_ITERS = 1 << 20


def _bind(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rr_symbol_sync_scan_lone.argtypes = [p, i, ll, f, f, p, i, p, i, p, p, p]
    lib.rr_symbol_sync_scan_lone.restype = i
    lib.rr_symbol_sync_events_lone.argtypes = [p, i, i, i, f, f, p, i, p, i, p,
                                               p, p, p]
    lib.rr_symbol_sync_events_lone.restype = i
    lib.rr_chain_calib.argtypes = [i, i, f, f, f, p, p, p]
    lib.rr_chain_calib.restype = i
    return lib


_YARDSTICKS = _buildcache.Library(
    lambda: cuda_lib.build(YARDSTICK_DIR, "librr_yardsticks"), _bind)


def scan_lone(x, sps, max_deviation, clock_taps, state):
    """Kernel E's function on the one-thread-per-channel yardstick:
    ``kernels.symbol_sync_scan``'s arguments and results, no launch
    counted."""
    k = kernels.sync_consts(sps, max_deviation, clock_taps)
    c, n = x.shape
    mask = torch.empty((c, n), dtype=torch.bool, device=x.device)
    clocks = torch.empty((c, n), dtype=torch.float32, device=x.device)
    out = state.clone()
    taps = np.asarray(k.taps, np.float32)
    cuda_lib.check(_YARDSTICKS.load().rr_symbol_sync_scan_lone(
        x.data_ptr(), c, n, k.sps, float(np.float32(max_deviation)),
        taps.ctypes.data, len(taps), out.data_ptr(), out.shape[1],
        mask.data_ptr(), clocks.data_ptr(), kernels._stream(x.device)),
        "symbol_sync_scan_lone")
    return mask, clocks, out


def events_lone(events, n, sps, max_deviation, clock_taps, fstate, istate,
                counts=None):
    """Kernel D's function on the one-thread-per-channel yardstick (which
    finds the padding itself and reads no ``counts``)."""
    k = kernels.sync_consts(sps, max_deviation, clock_taps)
    c, n_ev = events.shape
    ev_mid = torch.empty((c, n_ev), dtype=torch.float32, device=events.device)
    ev_clock = torch.empty_like(ev_mid)
    fout, iout = fstate.clone(), istate.clone()
    taps = np.asarray(k.taps, np.float32)
    cuda_lib.check(_YARDSTICKS.load().rr_symbol_sync_events_lone(
        events.data_ptr(), c, n_ev, n, k.sps, float(np.float32(max_deviation)),
        taps.ctypes.data, len(taps), fout.data_ptr(), fout.shape[1],
        iout.data_ptr(), ev_mid.data_ptr(), ev_clock.data_ptr(),
        kernels._stream(events.device)), "symbol_sync_events_lone")
    return ev_mid, ev_clock, fout, iout


def calibrate(device, iters: int = CALIB_ITERS) -> dict:
    """Cycles per link of a lone lane's dependent chain (f32 addition, IEEE
    division, add-compare-subtract step, an addition with a taken branch,
    and a warp's shuffle followed by an addition) and the SM clock in Hz
    under that load: the median of 5 launches each."""
    lib = _YARDSTICKS.load()
    out = torch.zeros(1, device=device)
    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    res, hz = {}, []
    for kind, name, (a, b, c) in (
            (0, "fadd_cycles", (0.0, 1.0, 0.0)),
            (1, "fdiv_cycles", (1.0, 1.0 + 2.0 ** -23, 0.0)),
            (2, "step_cycles", (0.0, 1.0, 367.5)),
            (3, "loop_cycles", (0.0, 1.0, 0.0)),
            (4, "shfl_add_cycles", (0.0, 1.0, 0.0))):
        per = []
        for _ in range(6):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            cuda_lib.check(lib.rr_chain_calib(
                kind, iters, a, b, c, out.data_ptr(), cycles.data_ptr(),
                kernels._stream(out.device)), "chain_calib")
            e.record()
            e.synchronize()
            per.append(int(cycles) / iters)
            hz.append(int(cycles) / (s.elapsed_time(e) * 1e-3))
        res[name] = statistics.median(per[1:])
    res["sm_hz"] = statistics.median(hz)
    return res


def noisy_nrz(c: int, n: int, sps: float, gen, device) -> torch.Tensor:
    """Random bits held for sps samples plus Gaussian noise of 0.1, (c, n)
    f32 on the card."""
    nbits = int(n / sps) + 2
    bits = torch.randint(0, 2, (c, nbits), generator=gen, device=device) * 2.0 - 1.0
    at = (torch.arange(n, device=device, dtype=torch.float64) / sps).long()
    return (bits[:, at] + 0.1 * torch.randn((c, n), generator=gen,
                                            device=device)).contiguous()


def same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("time_sync: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"label": argv[1] if len(argv) > 1 else "", "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()}
    out["calibration"] = calibrate(dev)

    def in_turns(name, calls, **forms):
        """Each form's outputs held equal to the first's, then the forms
        timed in turns, forwards and backwards."""
        first, *others = forms.values()
        want = first()
        for key, fn in zip(list(forms)[1:], others):
            if not same(fn(), want):
                raise SystemExit(f"time_sync: {name}: {key} differs from "
                                 f"{next(iter(forms))}")
        order = list(forms) + list(forms)[::-1]
        out[name] = {key: [] for key in forms}
        for key in order:
            out[name][key].append(graph_ms(lambda k: forms[key](), calls=calls))

    for c, n, slots, sps, taps in SHAPES_D:
        x = noisy_nrz(c, n, sps, gen, dev)
        case = sync_cases.SyncCase("", None, sps, 0.5, taps, (), slots)
        args = sync_cases.fresh_event_args(x, case, slots)
        del x
        counts = (args[0] < n).sum(1, dtype=torch.int32)
        in_turns(f"D {c} x {slots} slots ({int(counts.max())} real), sps {sps}, "
                 f"{len(taps)} taps", 2 if slots > 1 << 20 else 5,
                 kernel_ms=lambda: kernels.symbol_sync_events_scan(*args, counts),
                 no_counts_ms=lambda: kernels.symbol_sync_events_scan(*args),
                 one_thread_ms=lambda: events_lone(*args))
        del args
    for c, n, sps, taps in SHAPES_E:
        x = noisy_nrz(c, n, sps, gen, dev)
        k = kernels.sync_consts(sps, 0.5, taps)
        st = torch.tensor([k.sps, 0.0, 0.0, 0.0, k.sps / 2] + [k.sps] * k.nf,
                          device=dev).expand(c, -1).contiguous()
        in_turns(f"E {c} x {n} samples, sps {sps}, {len(taps)} taps",
                 2 if c * n > 1 << 21 else 5,
                 kernel_ms=lambda: kernels.symbol_sync_scan(x, sps, 0.5, taps, st),
                 one_thread_ms=lambda: scan_lone(x, sps, 0.5, taps, st))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
