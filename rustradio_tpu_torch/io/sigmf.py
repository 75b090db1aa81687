"""SigMF recording format (numpy copy of ``rustradio_tpu/io/sigmf.py``;
reference src/sigmf.rs).

A SigMF recording is ``<name>.sigmf-meta`` (JSON) + ``<name>.sigmf-data``
(raw samples), or a ``.sigmf`` tar archive containing both.  The reference
implements the meta structs, parse_meta, a writer helper, and SigMFSource
(sink is a TODO there — src/sigmf.rs:4-6; we implement both directions).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tarfile
from typing import Any

import numpy as np

#: datatype string -> (numpy dtype, is_complex)
_DATATYPES = {
    "cf32_le": (np.dtype("<c8"), True),
    "cf32": (np.dtype("<c8"), True),
    "cf64_le": (np.dtype("<c16"), True),
    "ci16_le": (np.dtype("<i2"), True),  # interleaved complex i16
    "ci8": (np.dtype("i1"), True),
    "cu8": (np.dtype("u1"), True),
    "rf32_le": (np.dtype("<f4"), False),
    "rf32": (np.dtype("<f4"), False),
    "ri16_le": (np.dtype("<i2"), False),
    "ru8": (np.dtype("u1"), False),
    "ri8": (np.dtype("i1"), False),
}


@dataclasses.dataclass
class Capture:
    """core:capture segment (reference src/sigmf.rs:29-66)."""

    sample_start: int = 0
    global_index: int | None = None
    header_bytes: int | None = None
    frequency: float | None = None
    datetime: str | None = None
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Annotation:
    """core:annotation (reference src/sigmf.rs:69-109)."""

    sample_start: int = 0
    sample_count: int | None = None
    generator: str | None = None
    label: str | None = None
    comment: str | None = None
    freq_lower_edge: float | None = None
    freq_upper_edge: float | None = None
    uuid: str | None = None


@dataclasses.dataclass
class Global:
    """core:global (reference src/sigmf.rs:112-163)."""

    datatype: str = "cf32_le"
    sample_rate: float | None = None
    version: str = "1.0.0"
    num_channels: int | None = None
    sha512: str | None = None
    description: str | None = None
    author: str | None = None
    recorder: str | None = None
    license: str | None = None
    hw: str | None = None
    extra: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SigMF:
    global_: Global
    captures: list[Capture] = dataclasses.field(default_factory=list)
    annotations: list[Annotation] = dataclasses.field(default_factory=list)


_CORE_GLOBAL = {
    "core:datatype": "datatype",
    "core:sample_rate": "sample_rate",
    "core:version": "version",
    "core:num_channels": "num_channels",
    "core:sha512": "sha512",
    "core:description": "description",
    "core:author": "author",
    "core:recorder": "recorder",
    "core:license": "license",
    "core:hw": "hw",
}
_CORE_CAPTURE = {
    "core:sample_start": "sample_start",
    "core:global_index": "global_index",
    "core:header_bytes": "header_bytes",
    "core:frequency": "frequency",
    "core:datetime": "datetime",
}
_CORE_ANNOTATION = {
    "core:sample_start": "sample_start",
    "core:sample_count": "sample_count",
    "core:generator": "generator",
    "core:label": "label",
    "core:comment": "comment",
    "core:freq_lower_edge": "freq_lower_edge",
    "core:freq_upper_edge": "freq_upper_edge",
    "core:uuid": "uuid",
}


def parse_meta(contents: str) -> SigMF:
    """Parse a .sigmf-meta JSON document (reference src/sigmf.rs:198-201)."""
    doc = json.loads(contents)
    g = doc.get("global", {})
    gl = Global(datatype=g.get("core:datatype", "cf32_le"))
    for k, attr in _CORE_GLOBAL.items():
        if k in g:
            setattr(gl, attr, g[k])
    gl.extra = {k: v for k, v in g.items() if k not in _CORE_GLOBAL}
    caps = []
    for c in doc.get("captures", []):
        cap = Capture()
        for k, attr in _CORE_CAPTURE.items():
            if k in c:
                setattr(cap, attr, c[k])
        cap.extra = {k: v for k, v in c.items() if k not in _CORE_CAPTURE}
        caps.append(cap)
    anns = []
    for a in doc.get("annotations", []):
        ann = Annotation()
        for k, attr in _CORE_ANNOTATION.items():
            if k in a:
                setattr(ann, attr, a[k])
        anns.append(ann)
    return SigMF(gl, caps, anns)


def dump_meta(meta: SigMF) -> str:
    g: dict[str, Any] = {}
    for k, attr in _CORE_GLOBAL.items():
        v = getattr(meta.global_, attr)
        if v is not None:
            g[k] = v
    g.update(meta.global_.extra)
    caps = []
    for c in meta.captures:
        d: dict[str, Any] = {}
        for k, attr in _CORE_CAPTURE.items():
            v = getattr(c, attr)
            if v is not None:
                d[k] = v
        d.update(c.extra)
        caps.append(d)
    anns = []
    for a in meta.annotations:
        d = {}
        for k, attr in _CORE_ANNOTATION.items():
            v = getattr(a, attr)
            if v is not None:
                d[k] = v
        anns.append(d)
    return json.dumps({"global": g, "captures": caps, "annotations": anns}, indent=2)


def _decode(data: bytes, datatype: str) -> np.ndarray:
    key = datatype.lower()
    if key not in _DATATYPES:
        raise ValueError(f"unsupported SigMF datatype {datatype!r}")
    dt, is_complex = _DATATYPES[key]
    raw = np.frombuffer(data, dtype=dt)
    if not is_complex:
        return raw.astype(np.float32) if raw.dtype.kind in "iu" else raw
    if dt.kind == "c":
        return raw.astype(np.complex64)
    # interleaved integer IQ
    scale = {1: 128.0, 2: 32768.0}[dt.itemsize]
    f = raw.astype(np.float32) / scale
    if dt.kind == "u":
        f = (raw.astype(np.float32) - 127.5) / scale
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def read(path: str, sample_rate: float | None = None):
    """Read a SigMF recording -> (samples, meta).

    ``path`` may be the basename, the -meta path, or a .sigmf tar.
    Like the reference's SigMFSource, an explicit sample_rate overrides/fills
    a missing core:sample_rate (src/sigmf.rs:240-244).
    """
    if path.endswith(".sigmf"):
        with tarfile.open(path) as tf:
            meta_name = next(n for n in tf.getnames() if n.endswith(".sigmf-meta"))
            data_name = next(n for n in tf.getnames() if n.endswith(".sigmf-data"))
            meta = parse_meta(tf.extractfile(meta_name).read().decode())
            data = tf.extractfile(data_name).read()
    else:
        base = path
        for suf in (".sigmf-meta", ".sigmf-data"):
            if base.endswith(suf):
                base = base[: -len(suf)]
        with open(base + ".sigmf-meta") as f:
            meta = parse_meta(f.read())
        with open(base + ".sigmf-data", "rb") as f:
            data = f.read()
    if sample_rate is not None:
        meta.global_.sample_rate = sample_rate
    samples = _decode(data, meta.global_.datatype)
    return samples, meta


def write(path: str, samples, sample_rate: float, frequency: float | None = None,
          datatype: str = "cf32_le", **global_fields) -> None:
    """Write a SigMF recording (the reference's sink is a TODO;
    this mirrors its write() helper, src/sigmf.rs:203-227)."""
    base = path
    for suf in (".sigmf-meta", ".sigmf-data"):
        if base.endswith(suf):
            base = base[: -len(suf)]
    meta = SigMF(Global(datatype=datatype, sample_rate=sample_rate, **global_fields))
    cap = Capture(sample_start=0, frequency=frequency)
    meta.captures.append(cap)
    with open(base + ".sigmf-meta", "w") as f:
        f.write(dump_meta(meta))
    arr = np.asarray(samples)
    dt, is_complex = _DATATYPES[datatype.lower()]
    if dt.kind == "c":
        arr = arr.astype(dt)
    elif is_complex:
        scale = {1: 128.0, 2: 32768.0}[dt.itemsize]
        inter = np.empty(2 * len(arr), np.float32)
        inter[0::2], inter[1::2] = arr.real, arr.imag
        arr = np.clip(np.round(inter * scale), np.iinfo(dt).min, np.iinfo(dt).max).astype(dt)
    else:
        arr = arr.astype(dt)
    with open(base + ".sigmf-data", "wb") as f:
        arr.tofile(f)
