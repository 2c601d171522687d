"""The engine's own 95th percentile of queue wait (``InferenceEngine.stats()``'s
``queue_p95_s``) over the requests launched by the window's close, in milliseconds."""


def read(ctx):
    if ctx.get("kind") != "serve" or "engine" not in ctx:
        return None
    return 1e3 * ctx["engine"]["queue_p95_s"]
