"""ntt_elems_per_s: points transformed in the window (a forward and an
inverse transform of n points count 2n) over its seconds (host clock, the
window ending with a synchronisation)."""


def read(run):
    elems = run.work.get("elems")
    return None if not elems else elems / run.window_s
