"""batch_fill.serve: percent of the batch's rows that carried a request, in
the batches decoded in the window, from CaptionService.stats()'s batch-fill
histogram."""

import math


def read(ctx):
    v = ctx.memo.get("fill_share")
    return None if v is None or math.isnan(v) else 100.0 * v
