from .fortran_records import (read_fortran_record, read_unformatted_cube,
                              write_fortran_record, write_unformatted_cube)
from .readers import read_density_file, read_clumping_file, read_lls_file
from .writers import OutputStreams, OutputWriter
from .checkpoint import load_iterdump, save_iterdump

__all__ = [
    "read_fortran_record", "write_fortran_record",
    "read_unformatted_cube", "write_unformatted_cube",
    "read_density_file", "read_clumping_file", "read_lls_file",
    "OutputStreams", "OutputWriter",
    "load_iterdump", "save_iterdump",
]
