"""setup_s: process start to the first timed request, build and warm-ups included."""


def read(run):
    return run.t_window - run.t_process
