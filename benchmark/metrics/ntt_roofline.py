"""The transforms' share of their roofline: the roofline seconds of the
window's transforms (benchmark/roofline: (n/2) log2 n field products a
transform at the card's integer multiply rate, or its bytes at the
bandwidth) over the card's busy seconds in the traced window."""


def read(run):
    roof = run.roofline_s.get("ntt")
    if run.trace is None or not roof or run.trace.busy_s <= 0:
        return None
    return 100.0 * roof / run.trace.busy_s
