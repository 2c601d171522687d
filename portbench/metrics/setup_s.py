"""Seconds from the process's start to the first timed step or request (host clock)."""


def read(ctx):
    return ctx.get("setup_s")
