"""Audio seconds of the clips' true lengths completed in the window,
over the window's length (issue to the last batch seen complete)."""


def value(w) -> float:
    return w.batches * w.audio_s_per_batch / w.seconds
