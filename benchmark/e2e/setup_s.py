"""``setup_s``: seconds from the process's start to the window's start
(inputs made, the program built, its shapes warmed)."""


def read(run):
    return run.setup_s
