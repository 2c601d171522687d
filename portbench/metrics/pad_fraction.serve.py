"""Percent of the rows the engine ran by the window's close that were padding (``stats()``'s ``pad_fraction``)."""


def read(ctx):
    if ctx.get("kind") != "serve" or "engine" not in ctx:
        return None
    return 100.0 * ctx["engine"]["pad_fraction"]
