"""Record a sample stream to SigMF (port of ``rustradio_tpu/apps/capture.py``;
reference examples/capture.rs / sigmf.rs).

Usage:
    python -m rustradio_tpu_torch.apps.capture -r in.c32 --sample_rate 1m \
        --frequency 144.8m --out capture

A file-to-file conversion on the host: it computes nothing, so it takes
no device.
"""

from __future__ import annotations

import argparse
import sys

from ..dtypes import parse_frequency
from ..io import rawfile, sigmf


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-r", "--read", required=True, help="raw c32 input")
    p.add_argument("--sample_rate", type=parse_frequency, required=True)
    p.add_argument("--frequency", type=parse_frequency, default=None)
    p.add_argument("--datatype", default="cf32_le")
    p.add_argument("--author")
    p.add_argument("--out", required=True, help="SigMF basename")
    opt = p.parse_args(argv)

    x = rawfile.read_samples(opt.read, "c32")
    kwargs = {}
    if opt.author:
        kwargs["author"] = opt.author
    sigmf.write(opt.out, x, float(opt.sample_rate), opt.frequency,
                datatype=opt.datatype, **kwargs)
    print(f"wrote {len(x)} samples to {opt.out}.sigmf-{{meta,data}}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
