"""``rtf``: wall seconds of the window over the seconds of audio that the
calls completed in it return (lower is better)."""


def read(run):
    return run.wall_s / run.audio_s if run.audio_s > 0 else None
