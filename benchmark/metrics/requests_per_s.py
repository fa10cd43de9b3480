"""Completed CG sets over the whole window's seconds (host clock)."""


def read(ctx):
    return ctx.completed / ctx.window_s if ctx.window_s > 0 and ctx.completed else None
