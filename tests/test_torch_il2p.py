"""The port's IL2P receiver and access-code correlator against the JAX
package: ``ops.correlate_access_code``, ``ops.il2p`` (descrambler, header
parse, deframer), the blocks ``CorrelateAccessCode``,
``CorrelateAccessCodeTag`` and ``Il2pDeframer``, ``models.ax25.
il2p_1200_rx`` and the app ``il2p_1200_rx``.

The reference's test input (``il2p.bits``) is not in this repository and
the JAX package has no IL2P encoder, so the bits are built by
``chip_smoke.py``'s encoder, the one the chip run decodes: each header is
packed as the inverse of ``parse_header``, two arbitrary FEC bytes added,
scrambled by the inverse of ``il2p_descramble`` and put after the sync
word 0xF15E48; the frames are placed here between seeded random bits.  Everything is
compared bit for bit (the correlator's matches, the headers, the tags);
the JAX side runs on the CPU, the port on the kernels' plain versions.

Two faults of the JAX package are pinned here (ROADMAP queue 3): its
``CorrelateAccessCodeTag`` cannot stream, and its ``Il2pDeframer`` loses a
header that straddles a chunk seam.  The port's streamed output equals its
offline output and the op's.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rustradio_tpu import blocks as jblocks
from rustradio_tpu import ops as jops
from rustradio_tpu.apps import il2p_1200_rx as jil2p_app
from rustradio_tpu.graph import Graph as JGraph
from rustradio_tpu.models import il2p_1200_rx as jil2p_1200_rx
from rustradio_tpu.ops import il2p as jil2p
from rustradio_tpu_torch import blocks, ops
from rustradio_tpu_torch.apps import il2p_1200_rx as il2p_app
from rustradio_tpu_torch.graph import Graph
from rustradio_tpu_torch.io import rawfile
from rustradio_tpu_torch.models import il2p_1200_rx
from rustradio_tpu_torch.ops import il2p

ROOT = Path(__file__).resolve().parent.parent

# (dst, dst ssid, src, src ssid, ui, pid, control, hdrtype1, payload size)
HEADERS = [
    ("2E0QQQ", 1, "M0THC", 1, False, 1, 1 << 2, True, 0),     # SABM
    ("APRS", 0, "N0CALL", 9, True, 15, 0, True, 1023),        # UI
    ("CQ", 15, "K1ABC", 3, False, 1, 3 << 2, True, 77),       # DISC
    ("X1", 2, "Y2", 12, False, 5, 0x55, False, 513),          # type0 IL2P
    ("AB1CDE", 4, "ZZ9ZZZ", 7, False, 6, 0x7F, True, 300),    # other PID
]
DESCRIBE = ["SABM", "UI", "DISC", "type0 IL2P", "other PID"]


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py of the repository root: the repository's one IL2P
    encoder (``il2p_header_bytes``, ``il2p_scramble``, ``il2p_frame``,
    ``il2p_capture``), which the chip run decodes as well."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "chip_smoke", mod)  # for its dataclass
        spec.loader.exec_module(mod)
    return mod


def il2p_stream(cs, n: int, at, seed: int, headers=HEADERS) -> np.ndarray:
    """``n`` seeded random bits with the frames of ``headers`` (FEC bytes
    0xA5 0x3C) placed so that each sync word ends at the position in
    ``at`` (a frame past the end is cut there)."""
    bits = np.random.RandomState(seed).randint(0, 2, n).astype(np.uint8)
    for end, fields in zip(at, headers):
        seg = bits[end - 23 : end - 23 + 144]
        seg[:] = cs.il2p_frame(fields, (0xA5, 0x3C))[: len(seg)]
    return bits


def _fields(h):
    return (h.dst, h.src, h.ui, h.fec, h.pid, h.control, h.hdrtype1,
            h.payload_size, h.describe())


def _want(headers=HEADERS):
    return [(f"{d}-{ds}", f"{s}-{ss}", ui, True, pid, ctl, t1, size, desc)
            for (d, ds, s, ss, ui, pid, ctl, t1, size), desc
            in zip(headers, DESCRIBE)]


# ---- the correlator

@pytest.mark.parametrize("diffs", [0, 1, 2, 3])
def test_torch_correlate_access_code_equals_jax(diffs):
    rng = np.random.RandomState(40 + diffs)
    code = rng.randint(0, 2, 24).astype(np.uint8)
    x = rng.randint(0, 2, 5000).astype(np.uint8)
    planted = 0
    for k, end in enumerate(range(100, 4900, 300)):  # copies with k % 5 flips
        w = code.copy()
        w[rng.choice(24, k % 5, replace=False)] ^= 1
        x[end - 23 : end + 1] = w
        planted += k % 5 <= diffs
    got = ops.correlate_access_code(torch.from_numpy(x), code, diffs)
    assert got.dtype == torch.uint8 and got.shape == (5000,)
    want = np.asarray(jops.correlate_access_code(x, code, diffs))
    assert np.array_equal(got.numpy(), want)
    assert got[:23].sum() == 0  # zeros while the window fills
    assert int(got.sum()) >= planted  # the copies within the diffs
    # a stream shorter than the code: all zeros
    assert ops.correlate_access_code(torch.from_numpy(x[:10]), code).sum() == 0
    with pytest.raises(ValueError, match="nonempty"):
        ops.correlate_access_code(torch.from_numpy(x), [])


# ---- descrambler, header parse, deframer

def test_torch_il2p_header_ops_equal_jax(cs):
    rng = np.random.RandomState(41)
    bits = rng.randint(0, 2, 600).astype(np.uint8)
    assert np.array_equal(il2p.il2p_descramble(bits), jil2p.il2p_descramble(bits))
    assert np.array_equal(il2p.il2p_descramble(cs.il2p_scramble(bits)), bits)
    for fields, desc in zip(HEADERS, DESCRIBE):
        d = cs.il2p_header_bytes(*fields)
        got, want = il2p.parse_header(d), jil2p.parse_header(d)
        assert _fields(got) == _fields(want)
        assert got.describe() == desc
    assert [_fields(il2p.parse_header(cs.il2p_header_bytes(*f))) for f in HEADERS] == _want()
    with pytest.raises(ValueError, match="13 bytes"):
        il2p.parse_header(np.zeros(12, np.uint8))
    assert il2p.decode_callsign(np.asarray([ord(c) - 0x20 for c in "M0THC "])) == "M0THC"


def test_torch_il2p_deframe_equals_jax(cs):
    # five headers, the last one cut by the end of the stream (skipped)
    bits = il2p_stream(cs, 1500, [100, 350, 600, 900, 1480], 42)
    got = il2p.il2p_deframe(bits)
    assert [_fields(h) for h in got] == _want()[:4]
    assert [_fields(h) for h in got] == [_fields(h) for h in jil2p.il2p_deframe(bits)]
    assert [_fields(h) for h in il2p.il2p_deframe(torch.from_numpy(bits))] == \
        [_fields(h) for h in got]


# ---- blocks, offline

def _graph(mod, graph_cls, bits, block, sink_cls):
    g, sink = graph_cls(), sink_cls()
    g.chain(mod.VectorSource(bits), block, sink)
    return g, sink


def test_torch_il2p_blocks_offline_equal_jax(cs):
    bits = il2p_stream(cs, 3000, [200, 900, 1500, 2100, 2700], 43)
    code = il2p.SYNC_WORD
    # CorrelateAccessCode: the match stream
    g, s = _graph(blocks, Graph, bits, blocks.CorrelateAccessCode(code, 1),
                  blocks.VectorSink)
    g.run(device="cpu")
    jg, js = _graph(jblocks, JGraph, bits, jblocks.CorrelateAccessCode(code, 1),
                    jblocks.VectorSink)
    jg.run()
    assert np.array_equal(s.data(), np.asarray(js.data()))
    # CorrelateAccessCodeTag: the data and the sync tags
    g, s = _graph(blocks, Graph, bits, blocks.CorrelateAccessCodeTag(code),
                  blocks.VectorSink)
    g.run(device="cpu")
    jg, js = _graph(jblocks, JGraph, bits, jblocks.CorrelateAccessCodeTag(code),
                    jblocks.VectorSink)
    jg.run()
    assert np.array_equal(s.data(), bits)
    tags = [(t.pos, t.key) for t in s.tags() if t.key == "sync"]
    assert tags == [(t.pos, t.key) for t in js.tags() if t.key == "sync"]
    assert [p for p, _ in tags] == [200, 900, 1500, 2100, 2700]
    # Il2pDeframer: one PDU per header, tagged
    dfr, jdfr = blocks.Il2pDeframer(), jblocks.Il2pDeframer()
    g, s = _graph(blocks, Graph, bits, dfr, blocks.PduVectorSink)
    g.run(device="cpu")
    jg, js = _graph(jblocks, JGraph, bits, jdfr, jblocks.PduVectorSink)
    jg.run()
    pdu_tags = [[(t.key, t.val) for t in p.tags] for p in s.pdus()]
    assert pdu_tags == [[(t.key, t.val) for t in p.tags] for p in js.pdus()]
    assert [t[2][1] for t in pdu_tags] == DESCRIBE
    assert dfr.decoded == jdfr.decoded == 5
    assert [_fields(h) for h in dfr.headers] == _want()


# ---- the two reference faults: streamed == offline == op in the port

SEAM_BITS = 6000
SEAM_AT = (500, 1990, 4000)  # sync words; chunks of 2048 cut two headers
SEAM_CHUNK = 2048


@pytest.mark.parametrize("chunk", [SEAM_CHUNK, 1, 24, 143, 1000])
def test_torch_correlate_access_code_tag_streams(cs, chunk):
    """The JAX package's block inherits the correlator's stream form, which
    never sets ``_match`` and returns the match stream as data: its
    ``run_stream`` raises AttributeError (``rustradio_tpu/blocks/
    digital.py:157``).  The port's streamed run passes the data through
    and tags every sync word where the offline run and the op do."""
    bits = il2p_stream(cs, SEAM_BITS, SEAM_AT, 44)
    code = il2p.SYNC_WORD
    want = list(np.flatnonzero(ops.correlate_access_code(torch.from_numpy(bits),
                                                         code).numpy()))
    assert want == list(SEAM_AT)
    g, off = _graph(blocks, Graph, bits, blocks.CorrelateAccessCodeTag(code),
                    blocks.VectorSink)
    g.run(device="cpu")
    g, st = _graph(blocks, Graph, bits, blocks.CorrelateAccessCodeTag(code),
                   blocks.VectorSink)
    g.run_stream(chunk_size=chunk, device="cpu")
    assert np.array_equal(st.data(), bits) and np.array_equal(off.data(), bits)
    assert [t.pos for t in st.tags() if t.key == "sync"] == want
    assert [t.pos for t in off.tags() if t.key == "sync"] == want
    # the match stream of CorrelateAccessCode streams as it runs offline
    g, m = _graph(blocks, Graph, bits, blocks.CorrelateAccessCode(code),
                  blocks.VectorSink)
    g.run_stream(chunk_size=chunk, device="cpu")
    assert list(np.flatnonzero(m.data())) == want
    if chunk == SEAM_CHUNK:
        jg, _ = _graph(jblocks, JGraph, bits, jblocks.CorrelateAccessCodeTag(code),
                       jblocks.VectorSink)
        with pytest.raises(AttributeError, match="_match"):
            jg.run_stream(chunk_size=chunk)


@pytest.mark.parametrize("chunk", [SEAM_CHUNK, 1, 143, 144, 700])
def test_torch_il2p_deframer_streams_across_seams(cs, chunk):
    """The JAX package's block keeps no state: streamed in chunks of 2048 it
    finds 1 of the 3 headers (the two across the seams at 2048 and 4096
    are lost, ``rustradio_tpu/blocks/packets.py:657``).  The port carries
    the last 143 bits and finds each header once, as offline and the op."""
    bits = il2p_stream(cs, SEAM_BITS, SEAM_AT, 45, HEADERS[:3])
    want = [_fields(h) for h in il2p.il2p_deframe(bits)]
    assert want == _want()[:3]
    for run in ("offline", "streamed"):
        dfr = blocks.Il2pDeframer()
        g, s = _graph(blocks, Graph, bits, dfr, blocks.PduVectorSink)
        if run == "offline":
            g.run(device="cpu")
        else:
            g.run_stream(chunk_size=chunk, device="cpu")
        assert [_fields(h) for h in dfr.headers] == want, run
        assert [p.tags[0].val for p in s.pdus()] == [w[1] for w in want]
    if chunk == SEAM_CHUNK:
        jdfr = jblocks.Il2pDeframer()
        jg, _ = _graph(jblocks, JGraph, bits, jdfr, jblocks.PduVectorSink)
        jg.run_stream(chunk_size=chunk)
        assert jdfr.decoded == 1  # the reference's miss


def test_torch_il2p_deframer_resumes_a_jax_state(cs, tmp_path):
    # a JAX checkpoint of a graph holding the correlator (its tail) and the
    # deframer (no state) resumes in the port; the correlator's match
    # stream and the headers continue as the port's one pass
    bits = il2p_stream(cs, SEAM_BITS, SEAM_AT, 46, HEADERS[:3])
    code = il2p.SYNC_WORD

    def chain(mod, graph_cls):
        g, m, s = graph_cls(), mod.VectorSink(), mod.PduVectorSink()
        src = g.add(mod.VectorSource(bits))
        g.add(m, g.add(mod.CorrelateAccessCode(code), src))
        dfr = mod.Il2pDeframer()
        g.add(s, g.add(dfr, src))
        return g, m, dfr

    ck = str(tmp_path / "il2p.pkl")
    jg, jm, jdfr = chain(jblocks, JGraph)
    jg.run_stream(chunk_size=1500, max_chunks=2, checkpoint_path=ck,
                  checkpoint_every=2)
    g, m, dfr = chain(blocks, Graph)
    g.run_stream(chunk_size=1500, resume_from=ck, device="cpu")
    match = np.concatenate([np.asarray(jm.data()), m.data()])
    assert list(np.flatnonzero(match)) == list(SEAM_AT)
    # the JAX part found the headers at 500 and 1990, the port the one at
    # 4000 (no header straddles the checkpoint at 3000: the JAX block
    # carries no tail across it)
    assert [h.src for h in jdfr.headers] + [h.src for h in dfr.headers] == \
        ["M0THC-1", "N0CALL-9", "K1ABC-3"]


# ---- the receiver and its app

@pytest.fixture(scope="module")
def capture(cs):
    bits = il2p_stream(cs, 1600, [150, 450, 750, 1050, 1350], 48)
    return cs.il2p_capture(bits, 47, noise=0.01, fs=50_000.0)


def test_torch_il2p_1200_rx_equals_jax(capture):
    got = il2p_1200_rx(capture, 50_000.0, device="cpu")
    want = jil2p_1200_rx(capture, 50_000.0)
    assert [_fields(h) for h in got] == [_fields(h) for h in want] == _want()
    with pytest.raises(ValueError, match="device="):
        il2p_1200_rx(capture, 50_000.0)
    # a tensor stays on its device
    assert [_fields(h) for h in il2p_1200_rx(torch.from_numpy(capture),
                                             50_000.0)] == _want()


def test_torch_il2p_1200_rx_app_equals_jax(capture, tmp_path, capsys):
    path = str(tmp_path / "il2p.c32")
    rawfile.write_samples(path, capture)
    assert jil2p_app.main(["-r", path]) == 0
    want = capsys.readouterr().out
    assert il2p_app.main(["-r", path, "--device", "cpu"]) == 0
    got = capsys.readouterr()
    assert got.out == want == "".join(f"{d}\n" for d in DESCRIBE)
    assert "decoded 5 IL2P headers" in got.err
