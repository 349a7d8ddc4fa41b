"""Share of the traced training window with no device operation in flight."""

from harness.readers import idle_percent


def read(ctx):
    return idle_percent(ctx)
