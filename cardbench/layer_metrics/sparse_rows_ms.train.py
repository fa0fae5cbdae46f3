"""Device ms a training step of the gathers, scatters, sorts and scans of the embedding rows and their
row-wise updates, by kernel name."""

import re

NAMES = re.compile(r"index|gather|scatter|embedding|sort|radix|unique|scan|cumsum", re.IGNORECASE)


def read(ctx):
    rows = [(s, e) for n, s, e in ctx.trace.kernels() if NAMES.search(n)]
    return 1e3 * sum(e - s for s, e in rows) / ctx.trace.n if rows else None
