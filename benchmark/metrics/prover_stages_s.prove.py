"""Mean seconds a proof spends in create_proof's stages after "runtime"
(advice commits, lookup permuted, grand products, quotient, evals,
shplonk), each ending in a synchronisation, from create_proof(timings=) in
the traced run."""


def read(run):
    spans = run.spans.get("device_stages")
    return None if not spans else sum(spans) / len(spans)
