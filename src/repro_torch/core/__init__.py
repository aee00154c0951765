"""Core MP-RW-LSH: hashing, multi-probe template, index, pipeline, segments."""
