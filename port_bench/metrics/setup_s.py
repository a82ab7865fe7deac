"""Set-up seconds: from the process's start to the window's, with the
imports, the kernels' build or load, tracing, templates, certification
and warm-up."""


def read(rec):
    return rec.setup_s
