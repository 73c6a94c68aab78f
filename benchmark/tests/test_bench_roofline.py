"""The sweep's roofline count against a count by hand."""

import bench_path  # noqa: F401  (the import path; first)

from harness import spec

ROOF = spec.roofline("sweep")


def _cfg(t_eff, isothermal, mesh=16):
    return {"mesh": mesh, "sed": {"bb": {"T_eff": t_eff, "S_star": 1.0}},
            "isothermal": isothermal}


def test_live_bands():
    # 1 HI band, 26 HeI sub-bands, and the HeII sub-bands whose lower
    # edge lies below 25 kT/h: 3.95 nu_HeII at 1e5 K (9 of 20), 1.97
    # at 5e4 K (6 of 20)
    assert ROOF.live_bands(1.0e5) == 1 + 26 + 9
    assert ROOF.live_bands(5.0e4) == 1 + 26 + 6


def test_sixteen_cubed_by_hand():
    # 16^3, 3 sources traced over [-7, 8]: 16^3 cells each
    cells = 16**3 * 3
    nodes = 36 * 6
    w = ROOF.trace_work(_cfg(1.0e5, False), 3, 8, 7, False)
    assert w["flops"] == cells * nodes * 25
    assert w["sfu"] == cells * nodes * 2
    assert w["bytes"] == 16**3 * 4 * (5 + 4)
    w = ROOF.trace_work(_cfg(5.0e4, True), 3, 8, 7, True)
    assert w["flops"] == cells * 33 * 6 * 10
    assert w["sfu"] == cells * (33 * 6 * 2 + 1)
    assert w["bytes"] == 16**3 * 4 * (5 + 1 + 4)
    # a subbox of radius 2: 5^3 cells a source, bytes over those cells
    w = ROOF.trace_work(_cfg(5.0e4, True), 3, 2, 2, False)
    assert w["sfu"] == 3 * 125 * 33 * 6 * 2
    assert w["bytes"] == 3 * 125 * 4 * 9


def test_least_time_is_the_slowest_unit():
    p = ROOF.PEAKS
    w = ROOF.trace_work(_cfg(1.0e5, False), 3, 8, 7, False)
    t, by = ROOF.least_seconds(_cfg(1.0e5, False), [(3, 8, 7, False)] * 2)
    want = max(w["flops"] / p["float32_flops_per_s"],
               w["sfu"] / p["sfu_ops_per_s"],
               w["bytes"] / p["bytes_per_s"])
    assert abs(t - 2 * want) <= 1e-12 * t and by == "sfu"
