"""Requests a dispatched group in the window, from DynamicBatcher.stats."""


def read(out):
    return out["requests"] / out["groups"] if out.get("groups") else None
