"""Seconds from the process's start to the window's opening: imports, kernel
builds (a cell's first run), weights, engine, warm-up and captures, the
prelude."""

def read(w):
    return w.setup_s
