"""Host-to-card streaming feed (port of ``rustradio_tpu/runtime.py``).

A pipelined path from a sample file to the card: the native reader thread
fills an SPSC ring (``native.Ring``, ``native.FileReader``), a feeder
thread converts each chunk to planar f32 into a pinned host buffer and
copies it to the card on a side CUDA stream, ahead of the consumer.
complex64 crosses the bus as two f32 planes, as in the JAX package;
``combine_iq`` forms complex64 on the card.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from . import native
from ._device import target_device

_BYTES_PER_SAMPLE = {"c32": 8, "u8iq": 2, "f32": 4, "i16be": 2}
_PLANES = {"c32": 2, "u8iq": 2, "f32": 1, "i16be": 1}
_POLL_S = 0.1  # how often a blocked feeder thread looks at the stop flag


def _convert(fmt: str, raw: np.ndarray, out: np.ndarray, n: int,
             use_native: bool) -> None:
    """``n`` samples of ``raw`` bytes in format ``fmt`` into ``out[:P*n]``
    as P planes of n f32 each (I then Q for complex formats), by the
    native converters or, without them, numpy."""
    planes = (out[:n], out[n : 2 * n]) if _PLANES[fmt] == 2 else None
    if fmt == "c32":
        x = raw[: 8 * n].view(np.complex64)
        if use_native:
            native.deinterleave_c64(x, out=planes)
        else:
            planes[0][:] = x.real
            planes[1][:] = x.imag
    elif fmt == "u8iq":
        if use_native:
            native.convert_u8iq_planar(raw[: 2 * n], 0.008, out=planes)
        else:
            f = raw[: 2 * n].astype(np.float32) - np.float32(127.0)
            planes[0][:] = f[0::2] * np.float32(0.008)
            planes[1][:] = f[1::2] * np.float32(0.008)
    elif fmt == "i16be":
        out[:n] = (native.convert_i16be_f32(raw[: 2 * n]) if use_native
                   else raw[: 2 * n].view(">i2").astype(np.float32)
                   * np.float32(1.0 / 32767.0))  # native's v * (1/32767)
    else:
        out[:n] = raw[: 4 * n].view(np.float32)


class DeviceFeeder:
    """Iterate device-resident chunks of a sample file.

    Yields ``(i, q)`` f32 tensors for complex formats ("c32", "u8iq") or a
    single f32 tensor for real formats ("f32", "i16be"), ``chunk_samples``
    each (the last one may be shorter), ``repeat`` passes over the file.

    On a CUDA device a feeder thread fills ``prefetch + 1`` pinned host
    buffers in turn and copies each to a fresh device tensor with
    ``non_blocking=True`` on a side stream, recording an event after the
    copy; a buffer is refilled only once its last copy's event has
    completed, and the consumer's stream waits on a chunk's event before
    the chunk is yielded.  Every chunk is a tensor of its own, so a later
    copy never overwrites one already yielded.  On the CPU the chunks are
    the converted host arrays.  Without the native library the file is
    read by Python (host I/O, as the JAX package does)."""

    def __init__(self, path: str, fmt: str = "c32", chunk_samples: int = 1 << 20,
                 repeat: int = 1, prefetch: int = 2, device="cuda"):
        if fmt not in _BYTES_PER_SAMPLE:
            raise ValueError(f"unknown format {fmt!r}; have {sorted(_BYTES_PER_SAMPLE)}")
        if chunk_samples <= 0 or prefetch <= 0:
            raise ValueError("chunk_samples and prefetch must be positive")
        self.device = target_device(device, "DeviceFeeder")
        self.fmt = fmt
        self.chunk = chunk_samples
        self._bps = _BYTES_PER_SAMPLE[fmt]
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._error: BaseException | None = None
        self._fallback = None
        self._native = native.available()
        if self._native:
            self._ring = native.Ring(max(1 << 22, 4 * chunk_samples * self._bps))
            self._reader = native.FileReader(self._ring, path, repeat)
        else:
            self._ring = self._reader = None
            self._fallback = open(path, "rb")
            self._fallback_repeat = repeat
        width = _PLANES[fmt] * chunk_samples
        if self.device.type == "cuda":
            self._side = torch.cuda.Stream(self.device)
            self._pinned = [torch.empty(width, dtype=torch.float32, pin_memory=True)
                            for _ in range(prefetch + 1)]
            self._copied: list = [None] * (prefetch + 1)
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _read_into(self, raw: np.ndarray) -> int:
        if self._ring is not None:
            return self._ring.read_into(raw)
        got = self._fallback.readinto(memoryview(raw))
        while got < len(raw) and self._fallback_repeat > 1:
            self._fallback_repeat -= 1
            self._fallback.seek(0)
            got += self._fallback.readinto(memoryview(raw)[got:])
        return got

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, raw: np.ndarray, n: int, k: int):
        planes = _PLANES[self.fmt]
        if self.device.type != "cuda":
            host = np.empty(planes * n, np.float32)
            _convert(self.fmt, raw, host, n, self._native)
            return torch.from_numpy(host).view(planes, n), None
        b = k % len(self._pinned)
        if self._copied[b] is not None:
            self._copied[b].synchronize()  # its last copy has left the buffer
        host = self._pinned[b]
        _convert(self.fmt, raw, host.numpy(), n, self._native)
        with torch.cuda.stream(self._side):
            dev = torch.empty((planes, n), dtype=torch.float32, device=self.device)
            dev.view(-1).copy_(host[: planes * n], non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._side)
        self._copied[b] = done
        return dev, done

    def _pump(self):
        want = self.chunk * self._bps
        raw = np.empty(want, np.uint8)
        try:
            k = 0
            while not self._stop.is_set():
                got = self._read_into(raw)
                n = got // self._bps
                if n == 0:
                    break
                if not self._put(self._to_device(raw, n, k)):
                    return
                k += 1
                if got < want:
                    break
        except BaseException as e:  # re-raised in the consumer's thread
            self._error = e
        finally:
            self._put(None)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._error is not None:
                    raise self._error
                if self._ring is not None and self._ring.error():
                    raise OSError(self._ring.error(), "native reader failed")
                return
            dev, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(done)
                dev.record_stream(consumer)
            yield (dev[0], dev[1]) if dev.shape[0] == 2 else dev[0]

    def close(self):
        """Stop the threads: the feeder at its next chunk, the native
        reader once the ring has room (the ring is drained meanwhile)."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)
        if self._reader is not None:
            stopper = threading.Thread(target=self._reader.stop, daemon=True)
            stopper.start()
            while stopper.is_alive():
                self._ring.read(1 << 16)
                stopper.join(timeout=0.01)
        if self._fallback is not None:
            self._fallback.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def combine_iq(i, q) -> torch.Tensor:
    """complex64 from f32 I and Q planes, on their device."""
    return torch.complex(torch.as_tensor(i).float(), torch.as_tensor(q).float())
