"""Share of a cycle's wall in which no operation ran on the device:
1 - the device's busy time in the profiled cycle (the union of its
operations' intervals) over the unprofiled wall of a cycle of the same
work in the traced run's window, in %."""


def read(trace):
    busy = trace["summary"]["busy_s"]
    wall = trace["cycle_wall_s"]
    if not busy or not wall:
        return None
    return 100.0 * (1.0 - busy / wall)
