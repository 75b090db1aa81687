"""Kernel H (``ops.kernels.pfb_channelize``, ``csrc/pfb_channelize.cu``):
the polyphase channelizer with each channel's power in one pass.

On the CPU: the plain path and its counters, the shape rule and the
refusal of a CUDA tensor of a shape outside it, the launch on the
tensor's device, the power's definition and the work count.  On the card
(marked ``cuda``, skipped without one): the kernel against its plain
version and against the float64 DDC reference
(``tools/band_reference.ddc_channels_f64``) over channel counts and taps a
branch, its edges (a ragged sample count, a ragged last tile, the zero
history of the first frames, a grid whose blocks walk many tiles), its
power, the channels the wideband receiver picks from it on the
benchmark's capture, its launch count, the wrapper's refusals, and (with
two cards or more) a launch on a card that is not the current one.  The
file imports no jax:

    python -m pytest tests/test_torch_channelizer_kernel.py -q
    python -m pytest tests/test_torch_channelizer_kernel.py -q -m cuda --noconftest
"""

import math

import numpy as np
import pytest
import torch

from rustradio_tpu_torch.ops import cuda_lib, kernels
from rustradio_tpu_torch.parallel import channelizer

# the widest gap over the reference's RMS: kernel H and the plain version
# against float64, and the two against each other.  Both round in f32: the
# branch sums (L products) and the inverse DFT (log2 M stages) each leave a
# few 2^-24 of the frame's magnitude, so over many outputs the widest gap
# reads a few 1e-6 of the RMS
F64_TOL = 2e-5
PAIR_TOL = 2e-5
POWER_TOL = 1e-5  # relative, the power against its definition


def _noise(rng, n, device="cpu"):
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    return torch.from_numpy(x).to(device)


def _taps(m, taps_per_branch):
    return channelizer.channelizer_taps(m, taps_per_branch)


def _gap(got, want) -> float:
    """The widest |got - want| over the RMS of ``want``."""
    want = want.to(torch.complex128)
    rms = float(want.abs().pow(2).mean().sqrt())
    return float((got.to(torch.complex128) - want).abs().max()) / rms


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---- on the CPU

def test_pfb_cpu_tensor_takes_the_plain_version():
    x = _noise(np.random.RandomState(0), 64 * 50 + 7)
    h = _taps(64, 8)
    before = dict(kernels.LAUNCHES)
    work = dict(kernels.WORK)
    got = kernels.pfb_channelize(x, h, 64)
    assert kernels.LAUNCHES == before
    assert torch.equal(got, kernels.pfb_channelize_plain(x, h, 64))
    assert got.shape == (50, 64) and got.dtype == torch.complex64
    b, f = kernels.pfb_work(x.shape[0], 64, 8)
    assert kernels.WORK["bytes"] - work["bytes"] == b
    assert kernels.WORK["flops"] - work["flops"] == f


@pytest.mark.parametrize("m, taps_per_branch, takes", [
    (16, 1, True), (128, 8, True), (1024, 16, True), (256, 16, True),
    (12, 8, False), (96, 8, False), (100, 4, False), (8, 8, False),
    (2048, 8, False), (128, 17, False), (64, 0, False)])
def test_pfb_shape_rule(m, taps_per_branch, takes):
    assert kernels.pfb_supported(m, taps_per_branch) is takes


@pytest.mark.parametrize("m, ntaps", [(12, 12 * 8), (128, 128 * 17),
                                      (96, 96 * 4 + 5)])
def test_pfb_cuda_shapes_outside_the_kernel_are_refused(monkeypatch, m, ntaps):
    # as a CUDA tensor would be routed: the shape alone refuses these,
    # before the kernel library is loaded; nothing falls back to the plain
    # version on the card
    monkeypatch.setattr(kernels, "_route", lambda t: True)

    def no_library():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(cuda_lib, "load", no_library)
    x = _noise(np.random.RandomState(1), m * 40 + 3)
    h = np.random.RandomState(2).randn(ntaps).astype(np.float32)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="pfb_supported"):
        kernels.pfb_channelize(x, h, m, power=True)
    assert kernels.LAUNCHES == before


def test_pfb_supported_shape_goes_to_the_kernel(monkeypatch):
    monkeypatch.setattr(kernels, "_route", lambda t: True)

    def no_library():
        raise RuntimeError("no library here")
    monkeypatch.setattr(cuda_lib, "load", no_library)
    with pytest.raises(RuntimeError, match="no library here"):
        kernels.pfb_channelize(_noise(np.random.RandomState(3), 128 * 9),
                               _taps(128, 8), 128)


class _Card:
    """A stand-in for the kernel library and ``torch.cuda.device`` on the
    CPU: it records the device made current around each C call."""

    def __init__(self):
        self.current, self.calls = None, []

    def device(self, device):
        card = self

        class Current:
            def __enter__(self):
                self.before, card.current = card.current, device

            def __exit__(self, *exc):
                card.current = self.before
        return Current()

    def rr_pfb_blocks(self, m, blocks):
        self.calls.append(("blocks", self.current))
        blocks._obj.value = 4
        return 0

    def rr_pfb_channelize(self, *args):
        self.calls.append(("channelize", self.current))
        return 0


def test_pfb_launch_runs_on_the_tensors_device(monkeypatch):
    # a shard's tensor need not lie on the current device: the wrapper
    # makes the tensor's device current for the C calls (the shared-memory
    # limit is set, and the launch enqueued, on that device)
    card = _Card()
    monkeypatch.setattr(kernels, "_route", lambda t: True)
    monkeypatch.setattr(kernels, "_stream", lambda device: 0)
    monkeypatch.setattr(cuda_lib, "load", lambda: card)
    monkeypatch.setattr(torch.cuda, "device", card.device)
    kernels._pfb_blocks.cache_clear()
    x = _noise(np.random.RandomState(3), 64 * 90)
    try:
        before = kernels.LAUNCHES["pfb_channelize"]
        ch, power = kernels.pfb_channelize(x, _taps(64, 8), 64, power=True)
    finally:
        kernels._pfb_blocks.cache_clear()
    assert card.calls == [("blocks", x.device), ("channelize", x.device)]
    assert card.current is None
    assert kernels.LAUNCHES["pfb_channelize"] == before + 1
    assert ch.shape == (90, 64) and power.shape == (64,)


def test_pfb_no_whole_frame_on_the_card_launches_nothing(monkeypatch):
    monkeypatch.setattr(kernels, "_route", lambda t: True)

    def no_library():
        raise AssertionError("the kernel library was loaded")
    monkeypatch.setattr(cuda_lib, "load", no_library)
    before = dict(kernels.LAUNCHES)
    ch, power = kernels.pfb_channelize(_noise(np.random.RandomState(4), 63),
                                       _taps(64, 8), 64, power=True)
    assert kernels.LAUNCHES == before
    assert ch.shape == (0, 64) and ch.dtype == torch.complex64
    assert power.shape == (64,)


@pytest.mark.parametrize("m", [16, 64, 128])
def test_pfb_channelize_power_is_the_plain_definition(m):
    x = _noise(np.random.RandomState(4), m * 300 + 11)
    h = _taps(m, 8)
    ch, power = channelizer.pfb_channelize_power(x, h, m)
    assert torch.equal(ch, channelizer.pfb_channelize(x, h, m))
    assert torch.equal(power, (ch.real ** 2 + ch.imag ** 2).mean(0))
    assert power.shape == (m,) and power.dtype == torch.float32


def test_pfb_work_is_the_roofline_metrics_count():
    from radiobench.metrics import channelizer_roofline

    config = {"n_channels": 128, "taps_per_branch": 8}
    n = 1 << 20
    assert kernels.pfb_work(n, 128, 8) == channelizer_roofline.work(n, config)


def test_pfb_wrapper_refuses_what_the_kernel_cannot_take():
    x = _noise(np.random.RandomState(6), 64 * 10)
    with pytest.raises(ValueError, match="complex64"):
        kernels.pfb_channelize(x.to(torch.complex128), _taps(64, 8), 64)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.pfb_channelize(x[::2], _taps(64, 8), 64)


# ---- on the card

CASES = [(m, lpb) for m in (16, 64, 128, 256, 1024) for lpb in (1, 8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("m, taps_per_branch", CASES)
def test_pfb_kernel_against_plain_and_float64(cuda_device, m, taps_per_branch):
    from rustradio_tpu_torch.tools.band_reference import ddc_channels_f64

    # three whole tiles and 5 frames more, and a ragged tail of samples
    frames = 3 * (kernels.PFB_TILE // m) + 5
    x = _noise(np.random.RandomState(m + taps_per_branch),
               frames * m + m // 2 + 3, cuda_device)
    h = _taps(m, taps_per_branch)
    before = kernels.LAUNCHES["pfb_channelize"]
    got = kernels.pfb_channelize(x, h, m)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pfb_channelize"] == before + 1
    assert got.shape == (frames, m) and got.is_contiguous()
    plain = kernels.pfb_channelize_plain(x, h, m)
    ref = ddc_channels_f64(x, h, m)
    gaps = {"kernel/f64": _gap(got, ref), "plain/f64": _gap(plain, ref),
            "kernel/plain": _gap(got, plain)}
    print(f"M={m} L={taps_per_branch}: {gaps}")
    assert gaps["kernel/f64"] <= F64_TOL and gaps["kernel/plain"] <= PAIR_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("taps_per_branch", [2, 8, 16])
def test_pfb_kernel_first_frames_have_zero_history(cuda_device, taps_per_branch):
    from rustradio_tpu_torch.tools.band_reference import ddc_channels_f64

    m = 128
    x = _noise(np.random.RandomState(7), m * 40, cuda_device)
    h = _taps(m, taps_per_branch)
    got = kernels.pfb_channelize(x, h, m)[:taps_per_branch]
    ref = ddc_channels_f64(x, h, m, frames=(0, taps_per_branch))
    assert _gap(got, ref) <= F64_TOL
    # the same frames of a capture that starts later: the kernel reads no
    # sample before the first
    late = torch.cat([torch.zeros(m * 3, dtype=x.dtype, device=x.device), x])
    again = kernels.pfb_channelize(late, h, m)[3:3 + taps_per_branch]
    assert _gap(again, ref) <= F64_TOL


@pytest.mark.cuda
def test_pfb_kernel_blocks_walk_many_tiles(cuda_device):
    # 2^22 samples at 128 channels: 512 tiles, more than the grid's blocks
    m = 128
    x = _noise(np.random.RandomState(8), (1 << 22) + 77, cuda_device)
    h = _taps(m, 8)
    got, power = kernels.pfb_channelize(x, h, m, power=True)
    plain = kernels.pfb_channelize_plain(x, h, m)
    assert _gap(got, plain) <= PAIR_TOL
    want = (got.real ** 2 + got.imag ** 2).mean(0)
    assert float(((power - want).abs() / want).max()) <= POWER_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 128, 1024])
def test_pfb_kernel_power_is_its_definition(cuda_device, m):
    x = _noise(np.random.RandomState(9), m * 3000 + 5, cuda_device)
    ch, power = kernels.pfb_channelize(x, _taps(m, 8), m, power=True)
    want = (ch.real ** 2 + ch.imag ** 2).mean(0)
    assert power.dtype == torch.float32 and power.shape == (m,)
    assert float(((power - want).abs() / want).max()) <= POWER_TOL
    # no atomics: the same power on a second call
    assert torch.equal(power, kernels.pfb_channelize(x, _taps(m, 8), m,
                                                     power=True)[1])


def _chosen(power, max_active=8, floor_db=-40.0):
    """The wideband receiver's choice of channels from their powers."""
    power = power.cpu().numpy()
    order = np.argsort(power)[::-1]
    floor = power[order[0]] * 10.0 ** (floor_db / 10.0)
    return [int(k) for k in order[:max_active] if power[k] > floor]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2_300_000_021, 2_300_000_022, 2_300_000_023])
def test_pfb_kernel_picks_the_plain_channels_on_the_band_capture(cuda_device, seed):
    from radiobench.generators import make_inputs
    from radiobench.harness import load_cell

    cell = load_cell("aprs_wideband.scan")
    m = int(cell.config["n_channels"])
    x = make_inputs(cell.traffic, cell.config, seed, cuda_device)["iq"]
    h = _taps(m, int(cell.config["taps_per_branch"]))
    _, power = kernels.pfb_channelize(x, h, m, power=True)
    kernel = _chosen(power)
    plain = _chosen(kernels.pfb_power_plain(kernels.pfb_channelize_plain(x, h, m)))
    print(f"seed {seed}: kernel {kernel}, plain {plain}")
    assert kernel == plain


@pytest.mark.cuda
def test_pfb_kernel_one_launch_a_call(cuda_device):
    from rustradio_tpu_torch.models import multichannel

    x = _noise(np.random.RandomState(10), 64 * 2000, cuda_device)
    before = kernels.LAUNCHES["pfb_channelize"]
    channelizer.pfb_channelize(x, _taps(64, 8), 64)
    channelizer.pfb_channelize_power(x, _taps(64, 8), 64)
    assert kernels.LAUNCHES["pfb_channelize"] == before + 2
    multichannel.decode_band_ax25(x, 2.048e6, n_channels=64, max_active=2)
    assert kernels.LAUNCHES["pfb_channelize"] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("m, ntaps", [(12, 96), (128, 128 * 17)])
def test_pfb_cuda_shapes_outside_the_kernel_raise(cuda_device, m, ntaps):
    x = _noise(np.random.RandomState(11), m * 50, cuda_device)
    h = np.random.RandomState(12).randn(ntaps).astype(np.float32)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="pfb_supported"):
        kernels.pfb_channelize(x, h, m)
    assert kernels.LAUNCHES == before
    # the plain version on the card, called by name
    assert kernels.pfb_channelize_plain(x, h, m).shape == (50, m)


@pytest.mark.cuda
def test_pfb_scanner_refuses_channels_the_kernel_does_not_take(cuda_device, capsys):
    from rustradio_tpu_torch.apps import scanner

    with pytest.raises(SystemExit) as e:
        scanner.main(["-r", "sim", "--sample_rate", "2.048m", "-n", "100"])
    assert e.value.code == 2
    assert "power of two in 16..1024" in capsys.readouterr().err


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs: a launch on a card that is not "
                    "the current one")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 128])
def test_pfb_kernel_on_a_card_that_is_not_current(two_cards, m):
    current, other = two_cards
    torch.cuda.set_device(current)
    x = _noise(np.random.RandomState(14), m * 700 + 9, other)
    h = _taps(m, 8)
    ch, power = kernels.pfb_channelize(x, h, m, power=True)
    torch.cuda.synchronize(other)
    assert torch.cuda.current_device() == current.index
    assert ch.device == other and power.device == other
    plain = kernels.pfb_channelize_plain(x, h, m)
    assert _gap(ch, plain) <= PAIR_TOL
    want = kernels.pfb_power_plain(plain)
    assert float(((power - want).abs() / want).max()) <= POWER_TOL


@pytest.mark.cuda
def test_pfb_sharded_bank_whose_line_starts_on_another_card(two_cards):
    from rustradio_tpu_torch.parallel.mesh import Mesh

    current, other = two_cards
    torch.cuda.set_device(current)
    m = 16
    x = _noise(np.random.RandomState(15), m * 900)
    h = _taps(m, 4)
    mesh = Mesh([other, current], ("chan",))
    got = channelizer.sharded_channelizer_fm(x, h, m, mesh)
    want = channelizer.channelizer_fm_bank(x, h, m)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)


@pytest.mark.cuda
def test_pfb_kernel_wrapper_refuses_what_the_kernel_cannot_take(cuda_device):
    x = _noise(np.random.RandomState(13), 128 * 100, cuda_device)
    h = _taps(128, 8)
    with pytest.raises(ValueError, match="complex64"):
        kernels.pfb_channelize(x.to(torch.complex128), h, 128)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.pfb_channelize(x[::2], h, 128)
    with pytest.raises(ValueError, match="complex64"):
        kernels.pfb_channelize(x.reshape(100, 128), h, 128)
    assert math.isfinite(float(kernels.pfb_channelize(x, h, 128).abs().max()))
