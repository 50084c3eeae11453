"""Mean seconds a proof's witness takes: the pinned prover builder and the
circuit's witness, by the host clock around them."""


def read(run):
    spans = run.spans.get("witness")
    return None if not spans else sum(spans) / len(spans)
