"""The MSM calls' share of their roofline: the roofline seconds of the
window's commitments (benchmark/roofline: a reference Pippenger's field
products at the card's integer multiply rate, or the bytes at its
bandwidth) over the card's busy seconds in the traced window."""


def read(run):
    roof = run.roofline_s.get("msm")
    if run.trace is None or not roof or run.trace.busy_s <= 0:
        return None
    return 100.0 * roof / run.trace.busy_s
