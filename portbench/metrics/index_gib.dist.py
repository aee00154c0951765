"""GiB of the distributed index on rank 0's card (its shard's rows, tables,
occupancy runs, histogram and template), from the ``index_bytes`` of rank
0's ``dist_query`` spans: what the card holds between requests, which
``peak_gib`` exceeds by the build's temporaries."""


def read(run):
    held = [s["args"]["index_bytes"] for s in run.spans
            if s.get("name") == "dist_query" and "index_bytes" in s.get("args", {})]
    return max(held) / 2 ** 30 if held else None
