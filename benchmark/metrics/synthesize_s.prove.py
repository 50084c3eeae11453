"""Mean seconds of create_proof's "synthesize" stage (the builder's flatten
into columns), from create_proof(timings=) in the traced run."""


def read(run):
    spans = run.spans.get("stage.synthesize")
    return None if not spans else sum(spans) / len(spans)
