"""proofs_per_s: proofs completed in the window over the window's seconds
(host clock, the window ending with its last proof)."""


def read(run):
    proofs = run.work.get("proofs")
    return None if not proofs else proofs / run.window_s
