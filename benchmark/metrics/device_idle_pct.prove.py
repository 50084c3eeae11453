"""Share of the traced window in which no kernel, copy or memset ran on the
card (torch.profiler's device activity, merged); nothing where the trace
holds no device activity (a run on the CPU)."""


def read(run):
    if run.trace is None or run.trace.device_events == 0 or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
