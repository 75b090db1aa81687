"""Dry runs of the multi-device layer (the port's counterparts of
``__graft_entry__.dryrun_multichip`` and ``dryrun_multihost``).

``dryrun_multichip(n, device=None)`` runs the sharded ops on an n-shard
mesh and holds each against the single-device offline chain: the sharded
FM chain, the 256-channel channelizer bank, the AX.25 1200 bd front-end
with its decode, a rate-changing two-stage pipeline, the channel-sharded
clock recovery (scan and events), the AX.25 receiver built from blocks on
the mesh (``Graph.run`` and ``run_stream(mesh=)``), and the IQ front-end
through a rate changer as one mesh segment of a Graph.
``dryrun_multihost(n_processes, devices_per_process)`` starts gloo CPU
processes with ``subprocess`` (CUDA hidden from them, so gloo) and runs
the sharded FM chain and quadrature demod on one mesh across them, halos
crossing the process boundaries, and a ``pipeline_run_rates`` of one
stage a process, the chunks handed across the boundaries.

    python -m rustradio_tpu_torch.tools.dryrun [n_devices] [--device cpu]
    python -m rustradio_tpu_torch.tools.dryrun --multihost
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
FS_IQ, DECI = 1_024_000.0, 4  # the FM chain: published taps, deci 4


def _fm_taps():
    from rustradio_tpu_torch import taps as tg

    return tg.low_pass_complex(FS_IQ, 100_000.0, 50_000.0, "hamming")


def _afsk(payload: bytes, fs: float) -> np.ndarray:
    from rustradio_tpu_torch import ops

    framed = np.asarray(ops.hdlc_frame(ops.fcs_add(np.frombuffer(payload, np.uint8))))
    line = (1 + np.cumsum(1 - framed)) % 2
    sps = fs / 1200.0
    m = int(len(line) * sps)
    bit_at = np.minimum((np.arange(m) / sps).astype(int), len(line) - 1)
    phase = np.cumsum(2 * np.pi * np.where(line[bit_at] == 1, 1200.0, 2200.0) / fs)
    z = np.zeros(500, np.float32)
    return np.concatenate([z, (0.5 * np.sin(phase)).astype(np.float32), z])


def _decode(nrz: torch.Tensor, fs: float) -> list[bytes]:
    from rustradio_tpu_torch import ops

    syms = ops.recover_symbols(nrz, fs / 1200.0, 0.5, (0.5, 0.5))
    bits = ops.nrzi_decode(ops.binary_slicer(torch.from_numpy(syms)))
    pkts, _ = ops.hdlc_deframe(bits, 10, 1500)
    return [bytes(np.asarray(d)) for d, _ in pkts]


def _close(got: torch.Tensor, want: torch.Tensor, atol: float, what: str) -> None:
    got, want = got.cpu(), want.cpu()
    m = min(got.shape[0], want.shape[0])
    err = float((got[:m] - want[:m]).abs().max()) if m else 0.0
    if not err <= atol:
        raise AssertionError(f"{what}: max |error| {err:.3e} > {atol:.1e}")


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One shot of every sharded op on an ``n_devices``-shard mesh
    (``make_mesh(n_devices, device=device)``: the first CUDA devices by
    default; ``device="cpu"`` or ``"cuda:0"`` puts every shard on one
    device), each held against the single-device offline chain.  Prints
    a line a check and returns ``{"ok": True, ...}``; a failed check
    raises AssertionError."""
    from rustradio_tpu_torch import blocks, ops, taps as tg
    from rustradio_tpu_torch.graph import Graph
    from rustradio_tpu_torch.models.ax25 import ax25_1200_rx, ax25_1200_rx_graph
    from rustradio_tpu_torch.models.multichannel import recover_symbols_batch
    from rustradio_tpu_torch.parallel import (
        channelizer_taps,
        make_mesh,
        pipeline_run_rates,
        sharded_bell202_demod,
        sharded_channelizer_fm,
        sharded_fm_demod,
        sharded_symbol_sync_bank,
    )

    mesh = make_mesh(n_devices, device=device)
    dev = mesh.devices[0]
    lp = _fm_taps()
    n = n_devices * 4096
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)).to(dev)
    out = sharded_fm_demod(x, lp, mesh, deci=DECI, gain=1.0)
    # the blocks' valid-conv streaming alignment
    expect = n // DECI - (len(lp) - 1) // DECI - 1
    assert out.shape == (expect,), out.shape
    want = ops.quadrature_demod(ops.fir_filter(x, lp, DECI), 1.0)
    _close(out, want, 3e-3, "sharded FM chain")
    print(f"dryrun_multichip({n_devices}): OK, {out.shape[0]} output samples")

    # the channel-parallel path: a 256-channel PFB and its FM bank, the
    # channel axis sharded over the same devices
    cmesh = make_mesh(n_devices, axis="chan", device=device)
    ctaps = channelizer_taps(256, 4)
    xw = torch.from_numpy((rng.randn(64 * 256) + 1j * rng.randn(64 * 256))
                          .astype(np.complex64)).to(dev)
    bank = sharded_channelizer_fm(xw, ctaps, 256, cmesh)
    assert bank.shape == (63, 256), bank.shape
    from rustradio_tpu_torch.parallel import channelizer_fm_bank

    _close(bank.reshape(-1), channelizer_fm_bank(xw, ctaps, 256).reshape(-1),
           1e-5, "sharded channelizer")
    print(f"dryrun_multichip({n_devices}): channelizer OK, {tuple(bank.shape)} "
          "demod bank")

    # the AX.25 1200 bd front-end sharded over the time axis, feeding the
    # clock recovery and HDLC: the decoded packets equal the offline chain's
    fs = 24_000.0
    payloads = [b"MESH DRYRUN FRAME ONE", b"MESH DRYRUN FRAME TWO"]
    audio = np.concatenate([_afsk(p, fs) for p in payloads])
    audio = np.concatenate([audio, np.zeros((-len(audio)) % (n_devices * 256),
                                            np.float32)])
    audio_t = torch.from_numpy(audio).to(dev)
    got = _decode(sharded_bell202_demod(audio_t, fs, mesh), fs)
    assert got == payloads, got
    assert got == [bytes(p) for p in ax25_1200_rx(audio_t, fs)]
    print(f"dryrun_multichip({n_devices}): AX.25 receiver OK, {len(got)} packets "
          "decoded on the mesh == single-device")

    # a stage-per-device pipeline with rate-changing stages: decimating
    # filter -> FM demod on 2 shards (the reference's thread-per-block
    # MTGraph)
    pmesh = make_mesh(2, axis="stage", device=device)

    def filt_deci(v):
        return v.reshape(-1, 4).mean(1)

    def pdemod(v):
        return ops.quadrature_demod(v, 1.0).to(torch.complex64)

    pchunks = torch.from_numpy((rng.randn(4, 2048) + 1j * rng.randn(4, 2048))
                               .astype(np.complex64)).to(dev)
    pout = pipeline_run_rates([(filt_deci, 2048, 512), (pdemod, 512, 511)],
                              pchunks, pmesh)
    for i in range(4):
        _close(pout[i], pdemod(filt_deci(pchunks[i])), 1e-5, f"pipeline chunk {i}")
    print(f"dryrun_multichip({n_devices}): rate-changing stage pipeline OK, "
          f"{tuple(pout.shape)} chunks through 2 stages")

    # the channel-sharded clock recovery == the single-device bank
    c, nbits, spsb = 2 * n_devices, 40, 10
    bits = rng.randint(0, 2, (c, nbits)) * 2.0 - 1.0
    xsb = torch.from_numpy(np.repeat(bits, spsb, axis=1).astype(np.float32)).to(dev)
    vs, ms, _ = sharded_symbol_sync_bank(xsb, float(spsb), cmesh)
    v1, m1, _ = recover_symbols_batch(xsb, float(spsb))
    assert torch.equal(ms.cpu(), m1.cpu())
    _close(vs.reshape(-1), v1.reshape(-1), 1e-6, "sharded bank")
    print(f"dryrun_multichip({n_devices}): channel-sharded symbol-sync bank OK, "
          f"{c} channels over {n_devices} shards == single-device")
    ve, me, _, valid = sharded_symbol_sync_bank(xsb, float(spsb), cmesh,
                                                method="events", return_valid=True)
    assert bool(valid.all()), "event budget overflow in dryrun"
    for k in range(c):
        _close(ve[k][me[k]], vs[k][ms[k]], 1e-5, f"events bank channel {k}")
    print(f"dryrun_multichip({n_devices}): channel-sharded EVENTS bank OK, "
          f"{c} channels == scan method")

    # the receiver built from blocks on the mesh: the dense front-end one
    # mesh segment, the clock recovery and the tail unsharded, offline and
    # streamed in halves
    gp = ax25_1200_rx_graph(audio_t, fs, mesh)
    assert gp == payloads, gp
    gs = ax25_1200_rx_graph(audio_t, fs, mesh, chunk_size=len(audio) // 2)
    assert gs == payloads, gs
    print(f"dryrun_multichip({n_devices}): Graph-built AX.25 receiver OK, "
          f"{len(gp)} packets on the mesh == single-device (offline + streaming)")

    # the IQ front-end THROUGH a rate changer as ONE mesh segment of a
    # Graph: FftFilter -> RationalResampler -> QuadratureDemod (reference
    # examples/ax25-1200-rx.rs:163-188), no split at the rate changer
    fs_iq, new_rate = 96_000.0, 48_000.0
    up = np.repeat(np.concatenate([_afsk(p, fs) for p in payloads]), int(fs_iq / fs))
    phase = np.cumsum(2 * np.pi * 3000.0 * up / fs_iq)
    iq = (np.cos(phase) + 1j * np.sin(phase)).astype(np.complex64)
    iq = np.concatenate([iq, np.zeros((-len(iq)) % (n_devices * 1024), np.complex64)])
    iq_t = torch.from_numpy(iq).to(dev)

    def front(mesh_):
        g = Graph()
        s = blocks.VectorSink()
        g.chain(blocks.VectorSource(iq_t),
                blocks.FftFilter(tg.low_pass_complex(fs_iq, 8_000.0, 2_000.0,
                                                     "hamming")),
                blocks.RationalResampler(int(new_rate), int(fs_iq)),
                blocks.QuadratureDemod(float(fs_iq / (2 * np.pi * 3000.0))), s)
        if mesh_ is not None:
            segs, _, plans = g._segments_mesh(mesh_, "time")
            assert len(plans) == 1 and len(segs[next(iter(plans))]) == 3, (
                "IQ front-end did not shard as one segment")
        g.run(device=dev, mesh=mesh_)
        assert g.demotions == [], g.demotions
        return torch.from_numpy(s.data())

    fm_mesh, fm_single = front(mesh), front(None)
    assert fm_mesh.shape == fm_single.shape, (fm_mesh.shape, fm_single.shape)
    pk_mesh = [bytes(p) for p in ax25_1200_rx(fm_mesh.to(dev), new_rate)]
    pk_single = [bytes(p) for p in ax25_1200_rx(fm_single.to(dev), new_rate)]
    assert pk_mesh == payloads and pk_single == payloads, (pk_mesh, pk_single)
    print(f"dryrun_multichip({n_devices}): IQ front-end with rate changer "
          f"sharded as ONE mesh segment, {len(pk_mesh)} packets == single-device")

    return {"ok": True, "devices": n_devices, "fm_outputs": int(out.shape[0]),
            "packets": len(got)}


_MULTIHOST_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist

from rustradio_tpu_torch import blocks, ops
from rustradio_tpu_torch.parallel.graph_mesh import chain_segment
from rustradio_tpu_torch.parallel import (
    init_distributed, make_mesh, pipeline_run_rates, sharded_fm_demod,
    sharded_quadrature_demod)
from rustradio_tpu_torch.tools.dryrun import DECI, _fm_taps

coord, nproc, pid, per = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
init_distributed(coordinator=coord, num_processes=nproc, process_id=pid)
assert dist.get_world_size() == nproc
# the time axis spans (process, shard): halos move within a process between
# shard neighbours and between the processes at their boundary
mesh = make_mesh(nproc * per, device="cpu")
lp = _fm_taps()
n = mesh.shape["time"] * 4096
rng = np.random.RandomState(0)
host_x = torch.from_numpy((rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64))
out = sharded_fm_demod(host_x, lp, mesh, deci=DECI, gain=1.0)


def gathered(part):
    # every process's part, tiled (process_allgather(tiled=True)); the
    # parts may differ in length (the stream-start drop is on process 0's)
    lens = [torch.zeros(1, dtype=torch.int64) for _ in range(nproc)]
    dist.all_gather(lens, torch.tensor([part.shape[0]]))
    size = max(int(v) for v in lens)
    parts = [torch.zeros(size) for _ in range(nproc)]
    dist.all_gather(parts, torch.cat([part, part.new_zeros(size - part.shape[0])]))
    return torch.cat([p[: int(v)] for p, v in zip(parts, lens)])


got = gathered(out)
# the same chain streamed in two chunks through MeshSegment.run_chunk: the
# tails the last process holds carry to the next chunk's global shard 0
ms = chain_segment([blocks.FirFilter(lp, DECI), blocks.QuadratureDemod(1.0)], mesh)
carries = ms.init_carries(host_x)
streamed = []
for c in (0, n // 2):
    carries, (o,), _ = ms.run_chunk(carries, host_x[c:c + n // 2], c)
    streamed.append(gathered(o))
assert torch.equal(torch.cat(streamed), got[: sum(t.shape[0] for t in streamed)])
# the right-hand halo: every process's parts are of one length
q = sharded_quadrature_demod(host_x, 1.0, mesh)
q_parts = [torch.zeros_like(q) for _ in range(nproc)]
dist.all_gather(q_parts, q)
q_got = torch.cat(q_parts)
# a stage-per-process pipeline: decimate by 4, the demod, then gains; the
# chunks cross every process boundary, and every process gets the outputs
stages = [(lambda v: v.reshape(-1, 4).mean(1), 2048, 512),
          (lambda v: ops.quadrature_demod(v, 1.0).to(torch.complex64), 512, 511)]
stages += [(lambda v: v * 0.5, 511, 511)] * (nproc - 2)
chunks = torch.from_numpy((rng.randn(4, 2048) + 1j * rng.randn(4, 2048))
                          .astype(np.complex64))
p_got = pipeline_run_rates(stages, chunks, make_mesh(nproc, axis="stage",
                                                     device="cpu"))
for i in range(4):
    y = chunks[i]
    for fn, _, _ in stages:
        y = fn(y)
    assert p_got.shape == (4, 511) and float((p_got[i] - y).abs().max()) <= 1e-5
if pid == 0:
    want = ops.quadrature_demod(ops.fir_filter(host_x, lp, DECI), 1.0)
    m = min(want.shape[0], got.shape[0])
    err = float((got[:m] - want[:m]).abs().max())
    assert err <= 3e-3 and m >= want.shape[0] - 1, (err, got.shape, want.shape)
    q_want = ops.quadrature_demod(host_x, 1.0)
    assert q_got.shape == (n,) and torch.equal(q_got[:-1], q_want)
    halo = (len(lp) - 1) * 8  # complex64 halo bytes per shard boundary
    print("MULTIHOST_OK", nproc, mesh.shape["time"], halo)
dist.destroy_process_group()
"""


def dryrun_multihost(n_processes: int = 2, devices_per_process: int = 4,
                     port: int = 29511) -> dict:
    """``n_processes`` gloo CPU processes × ``devices_per_process`` shards
    each: the sharded FM chain (left halos; also streamed in two chunks
    through ``MeshSegment.run_chunk``, its carries sent from the last
    process) and the sharded quadrature demod (right halos) run over one
    mesh spanning (process, shard) with the time axis crossing the
    process boundaries, validated without a second host; with three processes or more a middle process both sends
    and receives; and ``pipeline_run_rates`` with one stage a process
    (decimate by 4, the demod, then gains), every process holding the
    outputs against the composition.  Returns {"ok": bool, "processes",
    "devices", "halo_bytes"} (or "error")."""
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT)] + [p for p in os.environ.get("PYTHONPATH", "").split(
                       os.pathsep) if p]))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _MULTIHOST_WORKER, coord, str(n_processes),
             str(i), str(devices_per_process)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
            cwd=str(ROOT),
        )
        for i in range(n_processes)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=900)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        return {"ok": False, "error": "timeout"}
    ok = all(rc == 0 for rc, _, _ in outs) and any(
        "MULTIHOST_OK" in out for _, out, _ in outs
    )
    if not ok:
        return {
            "ok": False,
            "error": "; ".join(
                (out + err).strip()[-400:] for rc, out, err in outs if rc
            )[:1200],
        }
    line = next(out for _, out, _ in outs if "MULTIHOST_OK" in out)
    nproc, ndev, halo = line.strip().split()[-3:]
    print(f"dryrun_multihost: OK — {nproc} processes x "
          f"{int(ndev)//int(nproc)} devices, sharded FM chain == "
          f"single-device, {halo} halo bytes/boundary; a {nproc}-stage "
          f"pipeline across the processes == the composition")
    return {"ok": True, "processes": int(nproc), "devices": int(ndev),
            "halo_bytes": int(halo)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None,
                    help="put every shard on this device (e.g. cpu, cuda:0)")
    ap.add_argument("--multihost", action="store_true",
                    help="2 gloo CPU processes x 4 shards instead")
    args = ap.parse_args(argv)
    if args.multihost:
        return 0 if dryrun_multihost()["ok"] else 1
    return 0 if dryrun_multichip(args.n_devices, args.device)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
