"""Banked (windowed) row gather for large tables.

The rating evaluator sorts its index stream once (metric sums are
order-invariant), cuts it into segments whose index SPAN fits a fixed
row window, and gathers each segment from a ``dynamic_slice`` of the
table, so no single gather reads from the whole table. This was written
for an accelerator whose gather slowed sharply past a table-size
threshold; whether it beats a plain gather on a GPU is unmeasured.

Host side: :func:`banked_plan` builds the segmented layout. Device
side: :func:`banked_take` runs the scan-of-windows gather under jit.
"""

from __future__ import annotations

import numpy as np

# window: rows per dynamic-slice view (11-17 MB at MF widths of 40-64
# f32 columns).
WINDOW = 65_536
# segment capacity: indices per window segment. Must divide the
# evaluator's partial-sum chunk layout (multiples of 1024).
SEG_C = 65_536
# tables with fewer rows take the plain gather
MIN_ROWS = 262_144


def banked_plan(ids_sorted: np.ndarray):
    """Cut a SORTED int32 id stream into segments with id-span <=
    WINDOW and length <= SEG_C. Returns ``(seg_ids [S, SEG_C] int32,
    bases [S] int32, fill [S] int64)`` where ``seg_ids`` holds ABSOLUTE
    ids (pad slots repeat the segment's base id) and ``fill[s]`` is the
    number of real entries in segment s. Segment count is bounded by
    n/SEG_C + max_id/WINDOW."""
    n = int(ids_sorted.size)
    segs, bases, fills = [], [], []
    pos = 0
    while pos < n:
        end = min(pos + SEG_C, n)
        base = int(ids_sorted[pos])
        hi = base + WINDOW - 1
        if int(ids_sorted[end - 1]) > hi:
            end = int(np.searchsorted(ids_sorted, hi, side="right"))
        end = max(min(end, pos + SEG_C), pos + 1)
        seg = ids_sorted[pos:end]
        seg = np.pad(seg, (0, SEG_C - seg.size), constant_values=base)
        segs.append(seg.astype(np.int32))
        bases.append(base)
        fills.append(end - pos)
        pos = end
    if not segs:
        segs = [np.zeros(SEG_C, np.int32)]
        bases, fills = [0], [0]
    return (np.stack(segs), np.asarray(bases, np.int32),
            np.asarray(fills, np.int64))


def banked_take(table, seg_ids, bases):
    """Gather ``table[seg_ids]`` (absolute ids, [S, SEG_C]) through
    per-segment WINDOW-row dynamic-slice views. Returns rows flattened
    to [S * SEG_C, table.shape[1]] in segment order. Ids are clipped to
    their window (out-of-table ids must be masked by the caller, as
    with a plain clipped gather). Requires table rows >= WINDOW."""
    import jax
    import jax.numpy as jnp

    rows_total, width = table.shape
    b = jnp.clip(bases.astype(jnp.int32), 0, rows_total - WINDOW)

    def body(carry, xs):
        bb, ids = xs
        win = jax.lax.dynamic_slice(table, (bb, 0), (WINDOW, width))
        rel = jnp.clip(ids - bb, 0, WINDOW - 1)
        return carry, win[rel]

    _, rows = jax.lax.scan(body, 0, (b, seg_ids))
    return rows.reshape(-1, width)
