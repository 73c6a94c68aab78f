"""Output streams: the five result-file families of the reference.

Port of ``c2ray_tpu/io/writers.py`` (numpy; the files come out byte
for byte the same for equal arrays), after
``code/files_for_3D/output.F90``:
1. axis cut through the first source, ASCII `Ifront1_<z>.dat`
   (output.F90:192-244)
2. full ionization cubes `xfrac3d_<z>.bin`, `xfrac3dHe1_`, `xfrac3dHe2_`
   (f64, Fortran unformatted with mesh header) (output.F90:249-305)
3. `Temper3D_<z>.bin`, `IonRates3D_`, `HeatRates3D_` f32 cubes
   (output.F90:311-379)
4. midplane cuts `Ifront2d_{xy,xz,yz}_<z>.bin` of x_HII
   (output.F90:384-436)
5. density cuts `ndens_{xy,xz,yz}_<z>.bin` (output.F90:441-484)
plus the photon-statistics lines `PhotonCounts.out` /
`PhotonCounts2.out` (output.F90:489-542, photonstatistics.f90:272-318).
"""

import os
from dataclasses import dataclass, field

import numpy as np

from .fortran_records import write_unformatted_cube, write_fortran_record


def _zred_str(z) -> str:
    return f"{z:6.3f}".strip()


@dataclass
class OutputStreams:
    """Stream selection mask (setup_output, output.F90:48-125)."""

    axis_cut: bool = False        # stream 1
    ion_cubes: bool = True        # stream 2
    temper_rate_cubes: bool = False  # stream 3
    midplane_cuts: bool = False   # stream 4
    density_cuts: bool = False    # stream 5
    # H-only sign-coded single-value ionization cube `xh_compr_<z>.bin`
    # (the _compr output family, output_compr.F90; codec in
    # material.compress_ionized_fraction): halves snapshot bytes for
    # >=512^3 meshes while keeping full precision in the small fraction
    compressed_ion: bool = False


@dataclass
class OutputWriter:
    results_dir: str
    streams: OutputStreams = field(default_factory=OutputStreams)
    isothermal: bool = True

    def __post_init__(self):
        os.makedirs(self.results_dir, exist_ok=True)
        self._photon_counts = os.path.join(self.results_dir,
                                           "PhotonCounts.out")
        self._photon_counts2 = os.path.join(self.results_dir,
                                            "PhotonCounts2.out")

    def _path(self, stem, z, ext):
        return os.path.join(self.results_dir, f"{stem}{_zred_str(z)}{ext}")

    def write(self, z, *, xh, xhe, ndens, temperature=None,
              phih_grid=None, phiheat_grid=None, srcpos0=None):
        """Write all enabled streams for redshift z (output, output.F90).

        xh: (M,M,M,2); xhe: (M,M,M,3); ndens: (M,M,M); temperature
        (M,M,M); phih/phiheat flattened or 3D rate grids.
        """
        M = ndens.shape[0]
        reshape = lambda a: None if a is None else np.asarray(a).reshape(
            (M, M, M))
        phih_grid = reshape(phih_grid)
        phiheat_grid = reshape(phiheat_grid)

        if self.streams.axis_cut and srcpos0 is not None:
            j, k = int(srcpos0[1]), int(srcpos0[2])
            cols = [xh[:, j, k, 0], xh[:, j, k, 1], ndens[:, j, k],
                    xhe[:, j, k, 0], xhe[:, j, k, 1], xhe[:, j, k, 2]]
            if not self.isothermal and temperature is not None:
                cols.insert(3, temperature[:, j, k])
            with open(self._path("Ifront1_", z, ".dat"), "w") as f:
                for row in zip(*cols):
                    f.write(" ".join(f"{v:10.3e}" for v in row) + "\n")

        if self.streams.ion_cubes:
            write_unformatted_cube(self._path("xfrac3d_", z, ".bin"),
                                   xh[..., 1], dtype=np.float64)
            write_unformatted_cube(self._path("xfrac3dHe1_", z, ".bin"),
                                   xhe[..., 1], dtype=np.float64)
            write_unformatted_cube(self._path("xfrac3dHe2_", z, ".bin"),
                                   xhe[..., 2], dtype=np.float64)

        if self.streams.compressed_ion:
            from ..material import compress_ionized_fraction

            write_unformatted_cube(
                self._path("xh_compr_", z, ".bin"),
                compress_ionized_fraction(xh[..., 1]), dtype=np.float64)

        if self.streams.temper_rate_cubes:
            if temperature is not None:
                write_unformatted_cube(self._path("Temper3D_", z, ".bin"),
                                       temperature, dtype=np.float32)
            if phih_grid is not None:
                write_unformatted_cube(self._path("IonRates3D_", z, ".bin"),
                                       phih_grid, dtype=np.float32)
            if phiheat_grid is not None:
                write_unformatted_cube(self._path("HeatRates3D_", z, ".bin"),
                                       phiheat_grid, dtype=np.float32)

        if self.streams.midplane_cuts:
            h1 = xh[..., 1]
            for name, cut in (("Ifront2d_xy_", h1[:, :, M // 2]),
                              ("Ifront2d_xz_", h1[:, M // 2, :]),
                              ("Ifront2d_yz_", h1[M // 2, :, :])):
                with open(self._path(name, z, ".bin"), "wb") as f:
                    write_fortran_record(
                        f, np.asarray(cut.shape, dtype=np.int32))
                    write_fortran_record(f, cut.astype(np.float64))

        if self.streams.density_cuts:
            for name, cut in (("ndens_xy_", ndens[:, :, M // 2]),
                              ("ndens_xz_", ndens[:, M // 2, :]),
                              ("ndens_yz_", ndens[M // 2, :, :])):
                with open(self._path(name, z, ".bin"), "wb") as f:
                    write_fortran_record(
                        f, np.asarray(cut.shape, dtype=np.int32))
                    write_fortran_record(f, cut.astype(np.float32))

    def write_photon_counts(self, budget, photon_loss=None, dt=1.0):
        """PhotonCounts.out line (report_photonstatistics,
        photonstatistics.f90:289-299).

        `photon_loss` (photons/s) is legacy; new callers bake the
        losses into the budget (total_photon_loss/total_lls_loss,
        already x dt)."""
        total_src = float(budget.total_src)
        loss = (float(budget.total_photon_loss)
                + float(budget.total_lls_loss)
                if photon_loss is None else float(photon_loss) * dt)
        with open(self._photon_counts, "a") as f:
            vals = [float(budget.total_ion), total_src,
                    float(budget.recomions), loss,
                    float(budget.totrec), float(budget.totcollisions),
                    float(budget.totrec) / max(float(budget.total_ion),
                                               1e-300),
                    loss / max(total_src, 1e-300),
                    float(budget.totcollisions)
                    / max(float(budget.total_ion), 1e-300)]
            f.write(" ".join(f"{v:10.3e}" for v in vals) + "\n")

    def write_mean_ionization(self, z, xh, xhe, ndens, vol):
        """PhotonCounts2.out: volume- and mass-weighted mean ionized
        fractions (output.F90:489-542)."""
        w = ndens / ndens.sum()
        line = [z,
                xh[..., 1].mean(), (xh[..., 1] * w).sum(),
                xhe[..., 1].mean(), (xhe[..., 1] * w).sum(),
                xhe[..., 2].mean(), (xhe[..., 2] * w).sum()]
        with open(self._photon_counts2, "a") as f:
            f.write(" ".join(f"{v:12.5e}" for v in line) + "\n")
