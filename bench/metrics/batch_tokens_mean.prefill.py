"""Prompt tokens an engine step, over the window's steps up to the end of
the profiler's capture (the engine's batches as its outputs show them;
reading the capture stalls the engine, so the steps after it are left
out)."""


def read(rec):
    return rec.get("batch_tokens_mean")
