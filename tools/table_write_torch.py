#!/usr/bin/env python
"""Dump the radiation tables for inspection / regression (PyTorch port).

Port of ``tools/table_write.py`` onto ``c2ray_tpu_torch``, the analog of
the standalone ``code/files_for_1D/TableWrite.F90`` program: run the
radiation initialisation, then write the photo/heating thick+thin
tables to binary files for external comparison
(TableWrite.F90:126-144).  The tables are built on ``--device`` (the
card by default; "cuda" without CUDA exits with an error, it does not
fall back to the CPU).  They are integrated in numpy on the host and
then moved, so every device writes the same bytes.

Usage: python tools/table_write_torch.py [outdir] [--teff 5e4]
       [--sstar 1e48] [--quadrature] [--isothermal] [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402

from c2ray_tpu_torch.driver import _device_of  # noqa: E402
from c2ray_tpu_torch.io.fortran_records import (  # noqa: E402
    write_fortran_record)
from c2ray_tpu_torch.radiation import BlackBodySED, SEDConfig  # noqa: E402
from c2ray_tpu_torch.radiation.quadrature import (  # noqa: E402
    build_quadrature_tables)
from c2ray_tpu_torch.radiation.tables import (  # noqa: E402
    build_radiation_tables)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", nargs="?", default="./tables_out")
    ap.add_argument("--teff", type=float, default=5.0e4)
    ap.add_argument("--sstar", type=float, default=1.0e48)
    ap.add_argument("--isothermal", action="store_true")
    ap.add_argument("--quadrature", action="store_true",
                    help="dump the quadrature node data instead of "
                    "the tau tables")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)

    try:
        dev = _device_of(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    os.makedirs(args.outdir, exist_ok=True)
    sed = SEDConfig(bb=BlackBodySED(T_eff=args.teff, S_star=args.sstar))
    host = lambda t: t.cpu().numpy()

    if args.quadrature:
        # the dump format is the dense (nband, K) layout: request a
        # fixed rule (the "auto" rule returns uniform-K blocks); the
        # dtype is build_quadrature_tables' default, float32, as in the JAX
        # tool
        qt, sed_n, bands = build_quadrature_tables(
            sed, isothermal=args.isothermal, n_nodes=8, device=dev)
        np.savez(os.path.join(args.outdir, "bb_quadrature.npz"),
                 sigma_hat=host(qt.bb.sigma_hat),
                 A_photo=host(qt.bb.A_photo),
                 **({} if args.isothermal else {
                     "A_heat_HI": host(qt.bb.A_heat_HI),
                     "A_heat_HeI": host(qt.bb.A_heat_HeI),
                     "A_heat_HeII": host(qt.bb.A_heat_HeII)}))
        print(f"wrote quadrature data to {args.outdir}")
        return

    tables, sed_n, bands = build_radiation_tables(
        sed, isothermal=args.isothermal, device=dev)

    # same file set as TableWrite.F90:126-144
    names = {"bb_photo_thick_table.bin": tables.bb.photo_thick,
             "bb_photo_thin_table.bin": tables.bb.photo_thin}
    if not args.isothermal:
        names["bb_heat_thick_table.bin"] = tables.bb.heat_thick
        names["bb_heat_thin_table.bin"] = tables.bb.heat_thin
    for name, tab in names.items():
        with open(os.path.join(args.outdir, name), "wb") as f:
            write_fortran_record(f, host(tab).astype(np.float64))
    print(f"wrote {len(names)} tables to {args.outdir} "
          f"(S_star={sed_n.bb.S_star:.4e})")


if __name__ == "__main__":
    main()
