"""setup_s: process start to the window's start (host clock)."""


def read(ctx):
    return ctx["setup_s"]
