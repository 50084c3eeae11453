"""msm_points_per_s: columns x points committed in the window over its
seconds (host clock; every call ends with its commitments on the host)."""


def read(run):
    points = run.work.get("points")
    return None if not points else points / run.window_s
