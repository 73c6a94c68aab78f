"""The readings that the limits of `correct` are set from, on the card.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--out file.json]

For each seed, in one process: the cell's inputs from that seed, one
cycle through ``Run3D.run`` (the cell's own load: the capture of a
benchmark run's first cycle), and the compared numbers of the port
against the float64 reference (the lower readings).  For each control
seed also the numbers of the reference computed in bfloat16, the
precision below the configuration's float32, put in the port's place
(the upper readings).  A cell in the source-parallel mode runs on its
n_devices cards, one process each, the reference and the control on
rank 0.  The benchmark's own runs do not run this.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from harness import spec
    from harness.cell import build_libraries, engine_of, ranks_of, run3d_of

    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    run3d = run3d_of(spec.config(spec.cell(spec.benchmark(), args.workload)
                                 ["config"]), spec.traffic(args.workload))
    if run3d.get("parallel") is None:
        out = readings(args.workload, seeds, ctrl, args.out)
    else:
        from c2ray_tpu_torch.parallel.launch import launch

        build_libraries(engine_of(run3d))
        out = launch(readings, ranks_of(run3d),
                     args=(args.workload, seeds, ctrl, args.out),
                     threads=4)[0]
    print(json.dumps(out["summary"]))
    return 0


def readings(workload, seeds, ctrl, out_path):
    """The readings of `seeds` (and the control's of `ctrl`) in this
    process, on every rank of a source-parallel cell; rank 0's dict."""
    import torch

    from harness.cell import Cell

    out = {"workload": workload, "card": torch.cuda.get_device_name(0),
           "port": {}, "control": {}, "detail": {}, "control_detail": {}}
    order = ([s for s in seeds if s not in ctrl]
             + [s for s in seeds if s in ctrl] + sorted(ctrl - set(seeds)))
    for seed in order:
        t0 = time.perf_counter()
        wd = tempfile.mkdtemp(prefix="c2ray_readings_")
        cell = None
        try:
            cell = Cell(workload, seed, workdir=wd)
            cell.setup(warmup=False)
            cell.window(0.0)
            cell.release()
            if cell.rank != 0:
                continue
            ref = cell.reference()
            detail = {}
            nums, want, steps = cell.judged(ref, detail=detail)
            if seed in seeds:
                out["port"][seed] = nums
                out["detail"][seed] = {
                    k: max(((d, v) for d, v in detail.items()
                            if d.startswith(k + ".")), key=lambda x: x[1],
                           default=None) for k in nums}
            if seed in ctrl:
                cdet = {}
                out["control"][seed] = cell.control(want, steps,
                                                    torch.bfloat16, cdet)
                out["control_detail"][seed] = cdet
            del ref, want
        finally:
            shutil.rmtree(wd, ignore_errors=True)
            cell = None
            torch.cuda.empty_cache()
        if out_path:
            _write(out_path, out)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s "
              f"port {out['port'].get(seed)} control "
              f"{out['control'].get(seed)}", file=sys.stderr, flush=True)
    summary = {}
    for k in next(iter(out["port"].values()), {}):
        lo = max(v[k] for v in out["port"].values())
        up = (min(v[k] for v in out["control"].values())
              if out["control"] else None)
        summary[k] = {"lower": lo, "upper": up}
    out["summary"] = summary
    if out_path:
        _write(out_path, out)
    return out


def _write(path, out):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(out, indent=1, default=str))


if __name__ == "__main__":
    sys.path.insert(0, str(BENCH))
    sys.path.insert(1, str(BENCH.parent))
    sys.exit(main())
