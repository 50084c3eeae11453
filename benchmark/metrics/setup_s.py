"""setup_s: seconds from the process's start to the window's start
(imports, kernel loads or builds, SRS, keys, inputs, warm-up)."""


def read(run):
    return run.setup_s
