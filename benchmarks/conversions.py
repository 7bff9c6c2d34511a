#!/usr/bin/env python
"""All-pairs format-conversion timings (parity: performance/conversions/)."""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, ".")

from cusp_autotuned_tpu import gallery
from cusp_autotuned_tpu.ops.convert import convert
from cusp_autotuned_tpu.utils.exceptions import FormatConversionException

FORMATS = ("coo", "csr", "dia", "ell", "ellr", "hyb")


def run(grid: int = 300):
    A0 = gallery.poisson5pt(grid, grid, format="coo")
    print(f"# conversion times, poisson5pt({grid}x{grid}), "
          f"{A0.nnz} nnz (ms)")
    header = "src\\dst " + "".join(f"{f:>9}" for f in FORMATS)
    print(header)
    for src in FORMATS:
        try:
            A = convert(A0, src)
        except FormatConversionException:
            continue
        cells = []
        for dst in FORMATS:
            try:
                t0 = time.perf_counter()
                convert(A, dst)
                cells.append(f"{(time.perf_counter()-t0)*1e3:9.1f}")
            except FormatConversionException:
                cells.append(f"{'--':>9}")
        print(f"{src:8s}" + "".join(cells))


if __name__ == "__main__":
    run()
